"""Kernel K2's share of its roofline, in percent: the least time of the K2
launches of the traced window (each launch, a whole backbone with its head
at the cell's batch: its FLOPs at the peak rate or its bytes at the peak
bandwidth, whichever is longer) over their device time in the trace. The
launches are counted by the system's own counter."""

from port_bench.harness import costs

COUNTERS = {"k2_launches": "fall_multimodal_tpu_torch.ops.fused_backbone_v2:fused_backbone_forward.launches"}
KERNEL = "fused_backbone_kernel"


def read(run):
    tr, launches = run.trace, run.counters.get("k2_launches", 0)
    if tr is None or run.peaks is None or launches <= 0:
        return None
    m, n = run.cell.config["model"], run.cell.traffic["batch"]
    k, nnz = costs.adjacency_counts()
    least = costs.roofline_ms(*costs.backbone_cost(n, m["seq_len"], m["num_joints"],
                                                   m["in_channels"], m["stages"], k, nnz,
                                                   m["num_classes"]), run.peaks)
    device = tr.device_in_window()
    busy_ms = 1e3 * sum(e - s for name, s, e in zip(device.names, device.start, device.end)
                        if KERNEL in name)
    if busy_ms <= 0:
        return None
    return 100.0 * least * launches / busy_ms
