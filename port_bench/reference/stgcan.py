"""Plain PyTorch reference of the single-stream ST-GCAN classifier.

Written from the published architecture (ST-GCN, arXiv:1801.07455, with the
GSTCAN channel attention of the reference repository's ``Model/stgcan.py``)
in the original ``(N, C, T, V)`` layout with ``nn.Conv2d`` and
``BatchNorm2d``-style normalisation. Parameter and buffer names are the
reference repository's state_dict names (``data_bn``,
``st_gcn_networks.{i}.gcn.conv``, ``.tcn.{0,2,3}``,
``.channel_attention_module.atten.{1,2,4}``, ``.residual.{0,1}``,
``edge_importance.{i}``, ``A``, ``cls``), so one state_dict serves this
module and the program under test.

One departure from ``torch.nn.BatchNorm``, stated in the configuration
files: a train-mode forward moves the running variance by the *biased*
batch variance (the convention the system under test keeps), where torch's
module uses the unbiased one.

Imports nothing but ``torch`` and ``numpy``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (out_channels, stride, residual) per block, as the published model stacks them
STAGES: Tuple[Tuple[int, int, bool], ...] = (
    (64, 1, False), (64, 1, True), (64, 1, True), (128, 2, True),
    (128, 1, True), (256, 2, True), (256, 1, True),
)

# coco_cut: the 13 COCO body joints without eyes and ears, plus joint 13, the
# midpoint of the shoulders, as the skeleton's centre
COCO_CUT_BONES = ((6, 4), (4, 2), (2, 13), (13, 1), (5, 3), (3, 1), (12, 10),
                  (10, 8), (8, 2), (11, 9), (9, 7), (7, 1), (13, 0))
COCO_CUT_CENTER = 13


def spatial_adjacency(num_node: int = 14, bones=COCO_CUT_BONES,
                      center: int = COCO_CUT_CENTER) -> np.ndarray:
    """ST-GCN's ``Graph(strategy="spatial", max_hop=1)``: ``(3, V, V)``, the
    partitions (hop 0), (hop-1 pairs ``[j, i]`` whose ``j`` lies as far from
    the centre as ``i`` or further) and (the other hop-1 pairs), on the 1-hop
    graph normalised by column degree (``A D^-1``). Distances to the centre
    are hop distances clipped at max hop, as ST-GCN's ``hop_dis`` is: a
    joint two or more hops away is at infinity."""
    hop = np.full((num_node, num_node), np.inf)
    np.fill_diagonal(hop, 0)
    for i, j in bones:
        hop[i, j] = hop[j, i] = 1
    within = (hop <= 1).astype(np.float64)
    norm = within / within.sum(axis=0, keepdims=True)
    parts = np.zeros((3, num_node, num_node))
    for j in range(num_node):
        for i in range(num_node):
            if hop[j, i] == 0:
                parts[0, j, i] = norm[j, i]
            elif hop[j, i] == 1:
                closer_or_same = hop[j, center] >= hop[i, center]   # inf == inf counts
                parts[1 if closer_or_same else 2, j, i] = norm[j, i]
    return parts


class BatchNorm(nn.Module):
    """Batch normalisation over every axis but ``dim`` (1 for NCHW/NCL).
    Train mode: batch statistics, running statistics moved by momentum 0.1
    with the biased variance. Eval mode: running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)


class Block(nn.Module):
    """One ST-GCAN unit on ``(N, C, T, V)``: graph conv (1x1 conv to K
    partitions, contraction with the weighted adjacency), then BN, ReLU,
    9x1 temporal conv, BN, dropout slot; squeeze-excite gate; residual;
    ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, residual: bool):
        super().__init__()
        self.k, self.cout = k, cout
        self.gcn = nn.Module()
        self.gcn.conv = nn.Conv2d(cin, cout * k, 1)
        self.tcn = nn.Sequential(BatchNorm(cout), nn.ReLU(),
                                 nn.Conv2d(cout, cout, (9, 1), (stride, 1), (4, 0)),
                                 BatchNorm(cout), nn.Identity())
        hidden = cout // 4
        self.channel_attention_module = nn.Module()
        self.channel_attention_module.atten = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(cout, hidden, 1), BatchNorm(hidden), nn.ReLU(),
            nn.Conv2d(hidden, cout, 1), nn.Sigmoid())
        if not residual:
            self.res = "none"
        elif cin == cout and stride == 1:
            self.res = "identity"
        else:
            self.res = "proj"
            self.residual = nn.Sequential(nn.Conv2d(cin, cout, 1, (stride, 1)), BatchNorm(cout))

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        n, _, t, v = x.shape
        y = self.gcn.conv(x).view(n, self.k, self.cout, t, v)
        y = torch.einsum("nkctv,kvw->nctw", y, A)
        y = self.tcn(y)
        y = y * self.channel_attention_module.atten(y)
        if self.res == "identity":
            y = y + x
        elif self.res == "proj":
            y = y + self.residual(x)
        return F.relu(y)


class Backbone(nn.Module):
    """Data BN over (V, C), the blocks with learnable edge importance, global
    mean pool -> ``(N, C_last)``; with ``num_classes`` a 1x1 ``cls`` head."""

    def __init__(self, in_channels: int, stages: Sequence = STAGES, num_classes=None):
        super().__init__()
        A = torch.tensor(spatial_adjacency(), dtype=torch.float32)
        self.register_buffer("A", A)
        k, v, _ = A.shape
        self.data_bn = BatchNorm(v * in_channels)
        blocks, cin = [], in_channels
        for cout, stride, res in stages:
            blocks.append(Block(cin, cout, k, stride, res))
            cin = cout
        self.st_gcn_networks = nn.ModuleList(blocks)
        self.edge_importance = nn.ParameterList([nn.Parameter(torch.ones_like(A))
                                                 for _ in blocks])
        self.cls = nn.Conv2d(cin, num_classes, 1) if num_classes is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(N, T, V, C)`` windows."""
        n, t, v, c = x.shape
        y = x.permute(0, 2, 3, 1).reshape(n, v * c, t)          # (N, V*C, T)
        y = self.data_bn(y).view(n, v, c, t).permute(0, 2, 3, 1)  # (N, C, T, V)
        for block, importance in zip(self.st_gcn_networks, self.edge_importance):
            y = block(y, self.A * importance)
        y = F.adaptive_avg_pool2d(y, 1)                           # (N, C, 1, 1)
        if self.cls is not None:
            y = self.cls(y)
        return y.flatten(1)


class Classifier(Backbone):
    """The single-stream classifier: ``(skeleton, sensor) -> logits``; the
    sensor stream is not read."""

    def __init__(self, cfg: dict):
        super().__init__(cfg["in_channels"], [tuple(s) for s in cfg["stages"]],
                         cfg["num_classes"])

    def forward(self, skeleton: torch.Tensor, sensor=None) -> torch.Tensor:
        return super().forward(skeleton)


def build(cfg: dict) -> nn.Module:
    """The configuration file's model (``"model"`` section)."""
    return Classifier(cfg)
