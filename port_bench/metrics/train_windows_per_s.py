"""Train windows per second: the train windows of every completed epoch
over the time from the window's start to the end of the last completed
epoch, eval passes and checkpoint writes included, host clock."""


def read(run):
    return run.host["train_windows"] / run.host["window_s"]
