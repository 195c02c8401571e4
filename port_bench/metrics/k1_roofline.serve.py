"""Kernel K1's share of its roofline, in percent: the least time of the K1
launches of the traced window (each launch's FLOPs at the peak rate or its
bytes at the peak bandwidth, whichever is longer, from the cell's block
shapes) over their device time in the trace. The launches are counted by
the system's own counter; each forward makes one per block of each
backbone."""

from port_bench.harness import costs

COUNTERS = {"k1_launches": "fall_multimodal_tpu_torch.ops.stgcan_block:fused_stgcan_block.launches"}
KERNEL = "stgcan_block_kernel"


def read(run):
    tr, launches = run.trace, run.counters.get("k1_launches", 0)
    if tr is None or run.peaks is None or launches <= 0:
        return None
    m, n = run.cell.config["model"], run.cell.traffic["batch"]
    k, nnz = costs.adjacency_counts()
    streams = [(m["seq_len"], m["in_channels"])]
    if m["family"] == "gstcan_3stream":            # the motion stream: x, y deltas
        streams.append((m["seq_len"] - 1, 2))
    per_forward, blocks = 0.0, 0
    for t, cin in streams:
        for tt, ci, c, stride, mode in costs.block_plan(t, cin, m["stages"]):
            per_forward += costs.roofline_ms(
                *costs.block_cost(n, tt, m["num_joints"], ci, c, k, nnz, stride, mode), run.peaks)
            blocks += 1
    device = tr.device_in_window()
    busy_ms = 1e3 * sum(e - s for name, s, e in zip(device.names, device.start, device.end)
                        if KERNEL in name)
    if busy_ms <= 0:
        return None
    return 100.0 * per_forward * launches / blocks / busy_ms
