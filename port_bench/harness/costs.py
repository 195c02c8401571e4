"""Operations and bytes of the work the configurations ask for, from their
shapes alone, and the card's published peaks.

A FLOP count is twice the multiply-adds the algorithm needs, counted once
whatever the implementation does (split precision, recomputation, padding
do not raise it). The graph convolution's adjacency contraction is counted
over the adjacency's nonzeros, in the cheaper order (contract the adjacency
with the block's input channels, then mix). Bytes count each input and
weight read once and each output written once.
"""

from __future__ import annotations

import runpy
from typing import Dict, Iterable, Optional, Sequence, Tuple

# Published peaks, dense, per card (NVIDIA H100 SXM5 data sheet). TF32 is
# the highest rate any float32-accurate matrix product can reach on the
# card, so a float32 share of it cannot pass 100%.
PEAKS = {
    "H100": {"flops": 495e12, "bytes": 3.35e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``device_name``, or None for a card the
    table does not hold (its shares are then not reported)."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def block_weights(v: int, cin: int, c: int, k: int, mode: str) -> int:
    """Floats of one block's BN-folded constants: dense adjacency, mix and
    its bias, taps and their bias, two per-channel scales and shifts, the SE
    MLP, and for ``mode == "proj"`` the projection with its scale and
    shift."""
    h = c // 4
    n = k * v * v + cin * k * c + k * c + 9 * c * c + c + 4 * c + 2 * c * h + h + c
    return n + (cin * c + 2 * c if mode == "proj" else 0)


def block_cost(n: int, t: int, v: int, cin: int, c: int, k: int, nnz: int,
               stride: int, mode: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one eval ST-GCAN block on ``(n, t, v, cin)``: the
    channel mix, the adjacency contraction over its ``nnz`` nonzeros, the 9
    temporal taps, the squeeze-excite MLP and, for ``mode == "proj"``, the
    residual projection. Bytes: the input, the output and the constants of
    :func:`block_weights`, once each."""
    t_out = (t - 1) // stride + 1
    macs = (t * v * k * cin * c            # channel mix
            + t * nnz * cin                # adjacency contraction
            + t_out * v * 9 * c * c        # temporal taps
            + 2 * c * (c // 4))            # squeeze-excite
    if mode == "proj":
        macs += t_out * v * cin * c
    nbytes = 4.0 * (n * t * v * cin + n * t_out * v * c + block_weights(v, cin, c, k, mode))
    return 2.0 * n * macs, nbytes


def block_plan(t: int, cin: int, stages: Sequence) -> Iterable[Tuple[int, int, int, int, str]]:
    """``(t, cin, c, stride, mode)`` of each block of a backbone."""
    for c, stride, residual in stages:
        mode = "none" if not residual else ("identity" if cin == c and stride == 1 else "proj")
        yield t, cin, c, stride, mode
        t, cin = (t - 1) // stride + 1, c


def backbone_cost(n: int, t: int, v: int, cin: int, stages: Sequence, k: int, nnz: int,
                  classes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one whole-backbone call with its ``cls`` head: the
    blocks by :func:`block_cost`, the data BN, the mean pool and the head;
    the input, every constant and the logits once (the activations between
    blocks are not inputs or outputs of the call)."""
    c_last = stages[-1][0]
    flops, weights, t_last = 0.0, 2 * v * cin + c_last * classes + classes, t
    for tt, ci, c, stride, mode in block_plan(t, cin, stages):
        flops += block_cost(n, tt, v, ci, c, k, nnz, stride, mode)[0]
        weights += block_weights(v, ci, c, k, mode)
        t_last = (tt - 1) // stride + 1
    flops += n * (2 * t * v * cin + t_last * v * c_last + 2 * c_last * classes)
    return flops, 4.0 * (n * t * v * cin + n * classes + weights)


def backbone_macs(t: int, v: int, cin: int, stages: Sequence, k: int, nnz: int) -> float:
    """Multiply-adds of one window through a backbone's blocks."""
    return sum(block_cost(1, tt, v, ci, c, k, nnz, s, m)[0] / 2
               for tt, ci, c, s, m in block_plan(t, cin, stages))


def lstm_macs(t: int, features: int, hidden: int, directions: int = 2) -> float:
    """Gate products of a single-layer LSTM over ``t`` steps."""
    return directions * t * 4 * hidden * (features + hidden)


def forward_flops(model: dict, k: int, nnz: int) -> float:
    """FLOPs of one window through the published forward of a configuration's
    ``model`` section: dense GEMMs and convolutions, the adjacency
    contraction over its nonzeros, the LSTM's gate products and the heads
    (elementwise work, normalisation and pooling are not counted). The two
    STGCAN families are counted here; any other family's count is the
    ``forward_flops(model)`` of the configuration's reference module (the
    section's ``reference_file``)."""
    family = model["family"]
    if family not in ("stgcan", "gstcan_3stream"):
        return _reference_flops(model)
    t, v, cin, stages = model["seq_len"], model["num_joints"], model["in_channels"], \
        model["stages"]
    classes, c_last = model["num_classes"], stages[-1][0]
    if family == "stgcan":
        return 2 * (backbone_macs(t, v, cin, stages, k, nnz) + c_last * classes)
    s = model["sensor_dim"]
    t1 = t // 2
    t2 = t1 // 2
    sensor = (t * 16 * s * 5 + t1 * 32 * 16 * 5        # two Conv1d(k=5)
              + lstm_macs(t2, 32, 64)                  # BiLSTM(64) over T/4 steps
              + 2 * 128 * 16 + 128 * classes)          # channel attention, fc
    head = (2 * c_last + classes) * classes
    return 2 * (backbone_macs(t, v, cin, stages, k, nnz)
                + backbone_macs(t - 1, v, 2, stages, k, nnz) + sensor + head)


def _reference_flops(model: dict) -> float:
    """The reference module's ``forward_flops(model)``; raises, naming the
    function and the file to add it to, where there is none."""
    path = model.get("reference_file")
    count = None if path is None else runpy.run_path(path).get("forward_flops")
    if count is None:
        where = path or "the configuration's reference module, port_bench/reference/<name>.py"
        raise ValueError(f"no FLOP count for model family {model['family']!r}: add "
                         f"forward_flops(model), one window's FLOPs through the published "
                         f"forward, to {where}")
    return float(count(model))


def adjacency_counts() -> Tuple[int, int]:
    """(partitions, nonzeros) of the configurations' graph: coco_cut's 14
    joints, ST-GCN's spatial partitions at max hop 1."""
    from port_bench.reference.stgcan import spatial_adjacency

    a = spatial_adjacency()
    return a.shape[0], int((a != 0).sum())


def roofline_ms(flops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time of one call: its FLOPs at the peak rate or its bytes at
    the peak bandwidth, whichever takes longer."""
    return max(flops / peak["flops"], nbytes / peak["bytes"]) * 1e3
