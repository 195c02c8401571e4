"""Device activities (kernels, copies, sets) of the traced epochs, eval
passes and checkpoints included, per train step run in them."""

from port_bench.harness.trace import device_ops_per_step


def read(run):
    if run.trace is None:
        return None
    return device_ops_per_step(run.trace, run.host["traced_steps"])
