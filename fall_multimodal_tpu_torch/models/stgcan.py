"""GSTCAN / ST-GCAN backbone in PyTorch, ``(N, T, V, C)`` layout.

Counterpart of ``fall_multimodal_tpu/models/stgcan.py:31-146``. Module and
parameter names follow the notebook reference (``GSTCAN_UR_conv.ipynb:1``
``StreamSpatialTemporalGraph``): ``data_bn``, ``st_gcn_networks.{i}.gcn.conv``,
``.tcn.{0,2,3}``, ``.channel_attention_module.atten.{1,2,4}``,
``.residual.{0,1}``, ``edge_importance.{i}`` and the adjacency buffer ``A``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.graphs import build_adjacency
from fall_multimodal_tpu_torch.models.layers import (
    BatchNorm,
    Conv1x1,
    GraphConv,
    SqueezeExcite,
    TemporalConv,
)

# (out_channels, stride, residual) per block — reference ``stgcan.py:182-194``.
STGCAN_STAGES: Tuple[Tuple[int, int, bool], ...] = (
    (64, 1, False),
    (64, 1, True),
    (64, 1, True),
    (128, 2, True),
    (128, 1, True),
    (256, 2, True),
    (256, 1, True),
)


class STGCANBlock(nn.Module):
    """One st_gcan unit: GraphConv -> (BN, ReLU, TConv(9,1), BN, Dropout)
    -> SE channel attention -> + residual -> ReLU.

    ``residual_mode`` is ``"none"`` (first block), ``"identity"`` (same
    width, stride 1) or ``"proj"`` (1x1 conv + BN on ``x[:, ::stride]``).
    """

    def __init__(self, in_channels: int, out_channels: int, num_partitions: int,
                 temporal_kernel: int = 9, stride: int = 1, dropout: float = 0.0,
                 residual: bool = True, dense_gcn: bool = False):
        super().__init__()
        self.stride = stride
        self.gcn = GraphConv(in_channels, out_channels, num_partitions,
                             dense_mode=dense_gcn)
        self.tcn = nn.Sequential(
            BatchNorm(out_channels),
            nn.ReLU(),
            TemporalConv(out_channels, out_channels, temporal_kernel, stride),
            BatchNorm(out_channels),
            nn.Dropout(dropout),
        )
        self.channel_attention_module = SqueezeExcite(out_channels)
        if not residual:
            self.residual_mode = "none"
        elif in_channels == out_channels and stride == 1:
            self.residual_mode = "identity"
        else:
            self.residual_mode = "proj"
            self.residual = nn.Sequential(
                Conv1x1(in_channels, out_channels), BatchNorm(out_channels))

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        y = self.channel_attention_module(self.tcn(self.gcn(x, A)))
        if self.residual_mode == "identity":
            y = y + x
        elif self.residual_mode == "proj":
            y = y + self.residual(x[:, :: self.stride])
        return torch.relu(y)


class STGCANBackbone(nn.Module):
    """Full stream: data BN over the flattened (V, C) features, 7 STGCAN
    blocks with learnable per-block edge importance, global average pool
    -> ``(N, 256)`` features, or class logits through a 1x1 ``cls`` head
    (Gen-2 ``stgcan.py:208``) when ``num_classes`` is set."""

    def __init__(self, in_channels: int, graph_layout: str = "coco_cut",
                 graph_strategy: str = "spatial",
                 num_classes: Optional[int] = None,
                 stages: Sequence[Tuple[int, int, bool]] = STGCAN_STAGES,
                 dropout: float = 0.0, dense_gcn: bool = True):
        super().__init__()
        self.stages = tuple(tuple(s) for s in stages)
        A = torch.tensor(build_adjacency(graph_layout, graph_strategy),
                         dtype=torch.float32)
        self.register_buffer("A", A)
        k, v, _ = A.shape
        self.data_bn = BatchNorm(v * in_channels)
        blocks, cin = [], in_channels
        for ch, st, res in self.stages:
            blocks.append(STGCANBlock(
                cin, ch, k, stride=st, residual=res,
                dropout=dropout if res else 0.0, dense_gcn=dense_gcn))
            cin = ch
        self.st_gcn_networks = nn.ModuleList(blocks)
        self.edge_importance = nn.ParameterList(
            [nn.Parameter(torch.ones_like(A)) for _ in blocks])
        self.cls = Conv1x1(cin, num_classes) if num_classes is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, v, c = x.shape
        y = self.data_bn(x.reshape(n, t, v * c)).reshape(n, t, v, c)
        for i, block in enumerate(self.st_gcn_networks):
            y = block(y, self.A * self.edge_importance[i])
        y = y.mean(dim=(1, 2))
        if self.cls is not None:
            y = self.cls(y)
        return y


def motion_stream(skel: torch.Tensor) -> torch.Tensor:
    """Frame deltas of (x, y): ``(N, T, V, C>=2) -> (N, T-1, V, 2)``, sign
    ``t+1 - t`` (notebook/Gen-2 ``combination.py:39``)."""
    return skel[:, 1:, :, :2] - skel[:, :-1, :, :2]
