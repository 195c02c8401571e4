"""Host time of a serving call's batch preparation, in ms a call: the
system's ``predict.prep`` spans (cast, pad, ``torch.from_numpy``) in the
traced window over the ``predict_logits`` calls its counter counted there."""

from port_bench.harness import spans

COUNTERS = spans.present({"predict_calls": spans.PREDICT_CALLS})


def read(run):
    return spans.span_ms(run.trace, "predict.prep", run.counters.get("predict_calls", 0))
