"""Whole-step share of the card's peak while serving, in percent: the
published forward's FLOPs per window times the windows of the traced part
over its length, against the dense TF32 peak."""

from port_bench.harness import costs


def read(run):
    if run.trace is None or run.peaks is None or not run.host["traced_windows"]:
        return None
    k, nnz = costs.adjacency_counts()
    flops = costs.forward_flops(run.cell.config["model"], k, nnz) * run.host["traced_windows"]
    return 100.0 * flops / (run.trace.window_s * run.peaks["flops"])
