"""Device time of a train step's optimizer phase, in ms a step: the union of
the device activities launched from inside the system's ``step.optimizer``
spans (the gradient clip and the optimizer's update) in the traced epochs, each linked to its
launch by the trace's correlation ids, over the train steps the system's
counter counted there."""

from port_bench.harness import spans

COUNTERS = spans.present({"train_steps": spans.TRAIN_STEPS})


def read(run):
    return spans.device_ms(run, "step.optimizer", run.counters.get("train_steps", 0))
