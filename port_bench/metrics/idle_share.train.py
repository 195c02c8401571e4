"""Share of the traced window in which the device ran nothing (union of its
kernels, copies and sets), in percent."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
