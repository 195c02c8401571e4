"""Whole-step share of the card's peak while training, in percent: three
times the published forward's FLOPs per train window (forward and
backward), times the train windows of the traced epochs, over their
length, against the dense TF32 peak. Eval passes are not counted as work."""

from port_bench.harness import costs


def read(run):
    if run.trace is None or run.peaks is None or not run.host["traced_windows"]:
        return None
    k, nnz = costs.adjacency_counts()
    flops = 3 * costs.forward_flops(run.cell.config["model"], k, nnz) \
        * run.host["traced_windows"]
    return 100.0 * flops / (run.trace.window_s * run.peaks["flops"])
