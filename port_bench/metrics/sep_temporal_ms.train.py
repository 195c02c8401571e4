"""Device time of the musa family's separable temporal blocks in a train
step's forward, in ms a step: the union of the device activities launched
from inside the system's ``musa.temporal`` spans (each separable block's
depthwise and pointwise convolutions, their BatchNorms and its residual, and
the ``SepTCN`` tail, before DropGraph) that start inside a ``step.forward``
span, in the traced epochs, over the train steps the system's counter
counted there. Forward only: the backward of these ops is launched outside
the span; the eval passes' forwards are left out."""

from port_bench.harness import inside, nested, spans

COUNTERS = spans.present({"train_steps": spans.TRAIN_STEPS})


def read(run):
    return nested.device_ms_within(inside.only_inside(run, "musa.temporal", "step.forward"),
                                   "musa.temporal", run.counters.get("train_steps", 0))
