"""Device time of a TARGCN serving call's graph-GRU recurrence, in ms a
call: the union of the device activities launched from inside the system's
``targcn.recurrence`` spans (each layer's scan over the frames, its weight
generation included) in the traced window, each linked to its launch by the
trace's correlation ids, over the ``predict_logits`` calls its counter
counted there."""

from port_bench.harness import nested, spans

COUNTERS = spans.present({"predict_calls": spans.PREDICT_CALLS})


def read(run):
    return nested.device_ms_within(run, "targcn.recurrence", run.counters.get("predict_calls", 0))
