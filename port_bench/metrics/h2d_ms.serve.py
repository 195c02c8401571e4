"""Host time of a serving call's copies to the card, in ms a call: the
system's ``predict.h2d`` spans (the pose and sensor batches' ``.to(device)``
from pageable memory) in the traced window over the ``predict_logits``
calls its counter counted there."""

from port_bench.harness import spans

COUNTERS = spans.present({"predict_calls": spans.PREDICT_CALLS})


def read(run):
    return spans.span_ms(run.trace, "predict.h2d", run.counters.get("predict_calls", 0))
