"""Checkpoint stall, in percent: the share of the traced window in which the
device ran nothing while the host was inside the system's
``checkpoint.save`` spans (the file's write, its device reads and the swap)."""

from port_bench.harness import spans


def read(run):
    return spans.idle_inside_share(run.trace, "checkpoint.save")
