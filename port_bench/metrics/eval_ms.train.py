"""Device time of an epoch's eval pass, in ms an epoch: the union of the
device activities launched from inside the system's ``fit.eval`` spans (the
eval forward of every batch and the one read) in the traced epochs, over
the number of those spans. Not the spans' length: ``fit.eval`` opens while
the card still runs the train epoch's queued steps."""

from port_bench.harness import spans


def read(run):
    return spans.device_ms(run, "fit.eval")
