"""Device time of DropGraph in a train step's forward, in ms a step: the
union of the device activities launched from inside the system's
``musa.dropgraph`` spans (both DropBlocks of a block's main and residual
branches: the activity means, the Bernoulli draws, the permutation, the
spread and the rescale), in the traced epochs, over the train steps the
system's counter counted there. Forward only: the backward of the masking
is launched outside the span. None where the system's count of masked
branches did not move in the traced epochs, so that a program that skips
DropGraph in training reads nothing rather than 0."""

from port_bench.harness import nested, spans

COUNTERS = spans.present({
    "train_steps": spans.TRAIN_STEPS,
    "dropgraph_draws": "fall_multimodal_tpu_torch.models.musa:_DropGraphBlock.draws"})


def read(run):
    if run.counters.get("dropgraph_draws", 0) <= 0:
        return None
    return nested.device_ms_within(run, "musa.dropgraph", run.counters.get("train_steps", 0))
