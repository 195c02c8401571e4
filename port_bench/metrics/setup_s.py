"""Seconds from the process's start to the start of the window: imports,
the card's start, the kernels' build or load, the seeded weights and
inputs, the system's set-up and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
