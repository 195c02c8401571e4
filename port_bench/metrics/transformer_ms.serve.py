"""Device time of a TARGCN serving call's temporal transformer, in ms a
call: the union of the device activities launched from inside the system's
``targcn.transformer`` spans (the positional table and both attention
layers) in the traced window over the ``predict_logits`` calls its counter
counted there."""

from port_bench.harness import nested, spans

COUNTERS = spans.present({"predict_calls": spans.PREDICT_CALLS})


def read(run):
    return nested.device_ms_within(run, "targcn.transformer", run.counters.get("predict_calls", 0))
