"""Windows scored per second: every window of every call in the window over
the window's length, host clock, the last call's answer back on the host."""


def read(run):
    return run.host["windows"] / run.host["window_s"]
