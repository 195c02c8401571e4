"""Host time of a serving call's forward launch, in ms a call: the system's
``predict.launch`` spans (``Predictor.forward``: the host's enqueue of every
kernel launch and plain module) in the traced window over the
``predict_logits`` calls its counter counted there."""

from port_bench.harness import spans

COUNTERS = spans.present({"predict_calls": spans.PREDICT_CALLS})


def read(run):
    return spans.span_ms(run.trace, "predict.launch", run.counters.get("predict_calls", 0))
