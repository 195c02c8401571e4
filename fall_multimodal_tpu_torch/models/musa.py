"""Gen-3 flagship in PyTorch: the DropGraph-regularised two-stream GCN
("musa model"), ``(N, T, V, C)`` layout.

Counterpart of ``fall_multimodal_tpu/models/musa.py`` (reference
``Multimodal_Fall3/model/musa_model.py:39-687``): joint embedding, per-stream
stages of [SpatialGraphConv -> SepTemporal(k=3, s=1) -> SepTemporal(k=5,
s=2)] with channel doubling, a Sep_TCN tail, global pooling with a raw-input
pooled residual and an MLP head; and the two DropGraph regularisers. Module
and parameter names are the reference's: ``joint_embed_pos.cnn.0.cnn``,
``joint_embed_mos.cnn.0.cnn``, ``stream_{pos,mot}.{i}`` (the graph conv at
``3s``, the sep blocks at ``3s+1`` and ``3s+2``, the tail at ``3·n_stage``),
``fc.seq.{0,2,5}``; each graph and sep block saves the adjacency ``A`` it
was built with, which a checkpoint must match (``register_constant``).

Semantics kept from the reference:

* the graph conv ``einsum('nctv,cvw->nctw', x, A*edge)`` broadcasts a size-1
  partition axis across channels (``uniform`` strategy, K=1);
* the motion stream is ``x[t] - x[t+1]``, the reverse of Gen-2's;
* ``ClassificationModule`` and the separable convs use LeakyReLU slope 0.01,
  ``activation_factory('leakyrelu')`` 0.2;
* DropBlockT shuffles time with one permutation shared by the batch.

Every draw (DropGraph's Bernoulli seeds and permutation, the head's dropout)
comes from the ``generator`` a train-mode forward is given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fall_multimodal_tpu_torch.graphs import build_adjacency
from fall_multimodal_tpu_torch.models.layers import (
    BatchNorm,
    Conv1x1,
    Dropout,
    TemporalConv,
    activation_factory,
    register_constant,
    require_generator,
)


def _graph_apply(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """x (N,T,V,C), A (K,V,V): K == 1 broadcasts over channels (the shipped
    path), K == C contracts channelwise (the reference einsum's other case)."""
    if A.shape[0] == 1:
        return torch.einsum("ntvc,vw->ntwc", x, A[0])
    return torch.einsum("ntvc,cvw->ntwc", x, A)


def _adjacency(graph_layout: str, graph_strategy: str) -> torch.Tensor:
    return torch.tensor(build_adjacency(graph_layout, graph_strategy), dtype=torch.float32)


def _bernoulli(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.bernoulli(probs.clamp(0.0, 1.0), generator=require_generator(generator))


def _widen(m: torch.Tensor, block_size: int) -> torch.Tensor:
    """Max over a ``block_size`` window centred on each frame of (R, T).
    ``max_pool1d`` pads with -inf where the reference pads with 0; m >= 0,
    so the ``max(., 0)`` makes the two agree."""
    pad = block_size // 2
    out = F.max_pool1d(m[:, None, :], block_size, stride=1, padding=pad)[:, 0]
    return out.clamp(min=0.0)[:, : m.shape[1]]


def drop_block_ske(x: torch.Tensor, keep_prob: float, A: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Graph-structured spatial DropBlock (``musa_model.py:39-73``): Bernoulli
    seeds proportional to each joint's mean activity, spread one hop over the
    adjacency, inverted, rescaled by numel / kept."""
    n, t, v, c = x.shape
    act = x.detach().abs().mean(dim=(1, 3))                  # (n, v)
    act = act / act.sum() * act.numel()
    denom = 1.9 if v == 20 else 1.92                         # reference: 1.92 unless V == 20
    seed = _bernoulli(act * ((1.0 - keep_prob) / (1.0 + denom)), generator)
    A2 = (A[0] if A.dim() == 3 else A).detach().to(x.dtype)
    mask = 1.0 - ((seed @ A2) > 0.001).to(x.dtype)           # (n, v)
    return x * mask[:, None, :, None] * (mask.numel() / mask.sum().clamp(min=1.0))


def drop_block_t(x: torch.Tensor, keep_prob: float, block_size: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Time-shuffled temporal DropBlock (``musa_model.py:76-98``): Bernoulli
    frame seeds proportional to each frame's activity, widened by a
    ``block_size`` max-pool, then permuted over time (one permutation for
    the batch), inverted, rescaled."""
    n, t = x.shape[:2]
    act = x.detach().abs().mean(dim=(2, 3))                  # (n, t)
    act = act / act.sum() * act.numel()
    m = _bernoulli(act * ((1.0 - keep_prob) / block_size), generator)
    perm = torch.randperm(t, generator=generator, device=x.device)
    mask = 1.0 - _widen(m, block_size)[:, perm]              # (n, t)
    return x * mask[:, :, None, None] * (mask.numel() / mask.sum().clamp(min=1.0))


class _DropGraphBlock(nn.Module):
    """What the graph conv and the sep blocks share: the saved adjacency
    ``A``, the learnable ``edge`` mask, and DropGraph on (main, residual)."""

    def __init__(self, act_type: str, keep_prob: float, block_size: int, edge: bool,
                 graph_layout: str, graph_strategy: str):
        super().__init__()
        self.act = activation_factory(act_type)
        self.keep_prob = keep_prob
        self.block_size = block_size
        A = _adjacency(graph_layout, graph_strategy)
        register_constant(self, "A", A)
        self.edge = nn.Parameter(torch.ones_like(A)) if edge else None

    def graph(self) -> torch.Tensor:
        return self.A * self.edge if self.edge is not None else self.A

    def drop(self, generator, *branches):
        """DropGraph on each branch (the main one, then the residual) in
        train mode (``keep_prob < 1``)."""
        if not self.training or self.keep_prob >= 1.0:
            return branches
        A = self.graph()
        out = []
        for z in branches:
            z = drop_block_ske(z, self.keep_prob, A, generator)
            out.append(drop_block_t(z, self.keep_prob, self.block_size, generator))
        return tuple(out)


class MusaSpatialGraphConv(_DropGraphBlock):
    """``gcn`` 1x1 -> contraction with ``A * edge`` -> ``bn`` -> DropGraph on
    the main and residual branches -> activation (``musa_model.py:101-146``).
    The residual is ``residual.{0,1}`` (1x1 + BN) when the width changes."""

    def __init__(self, in_channels: int, out_channels: int, act_type: str = "relu",
                 keep_prob: float = 0.9, block_size: int = 41, edge: bool = True,
                 bias: bool = True, graph_layout: str = "coco_cut",
                 graph_strategy: str = "uniform"):
        super().__init__(act_type, keep_prob, block_size, edge, graph_layout, graph_strategy)
        self.gcn = Conv1x1(in_channels, out_channels, bias=bias)
        self.bn = BatchNorm(out_channels)
        self.residual = (nn.Sequential(Conv1x1(in_channels, out_channels, bias=bias),
                                       BatchNorm(out_channels))
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        res = self.residual(x) if self.residual is not None else x
        y = self.bn(_graph_apply(self.gcn(x), self.graph()))
        y, res = self.drop(generator, y, res)
        return self.act(y + res)


class SepTemporalBlock(_DropGraphBlock):
    """[``expand_conv`` (1x1 to ``channels * expand_ratio``, BN) ->
    activation] -> ``depth_conv`` (depthwise (k,1), BN) -> activation ->
    ``point_conv`` (1x1 back to ``channels``, BN); DropGraph on both
    branches; the residual is ``x`` at stride 1 and ``residual.{0,1}`` (1x1
    + BN on ``x[:, ::stride]``) at stride 2, or none with ``residual=False``
    (then DropGraph takes the main branch only) (``musa_model.py:148-199``;
    registered models build ``expand_ratio=0`` with a residual)."""

    def __init__(self, channels: int, temporal_window: int = 3, stride: int = 1,
                 expand_ratio: int = 0, act_type: str = "relu", keep_prob: float = 0.9,
                 block_size: int = 41, edge: bool = True, bias: bool = True,
                 residual: bool = True, graph_layout: str = "coco_cut",
                 graph_strategy: str = "uniform"):
        super().__init__(act_type, keep_prob, block_size, edge, graph_layout, graph_strategy)
        self.stride = stride
        self.use_residual = residual
        inner = channels * expand_ratio if expand_ratio > 0 else channels
        self.expand_conv = (nn.Sequential(Conv1x1(channels, inner, bias=bias), BatchNorm(inner))
                            if expand_ratio > 0 else None)
        self.depth_conv = nn.Sequential(
            TemporalConv(inner, inner, temporal_window, stride, bias=bias, groups=inner),
            BatchNorm(inner))
        self.point_conv = nn.Sequential(Conv1x1(inner, channels, bias=bias),
                                        BatchNorm(channels))
        self.residual = (nn.Sequential(Conv1x1(channels, channels, bias=bias),
                                       BatchNorm(channels))
                         if residual and stride != 1 else None)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = x if self.expand_conv is None else self.act(self.expand_conv(x))
        y = self.point_conv(self.act(self.depth_conv(y)))
        if not self.use_residual:
            (y,) = self.drop(generator, y)
            return self.act(y)
        res = x if self.residual is None else self.residual(x[:, :: self.stride])
        y, res = self.drop(generator, y, res)
        return self.act(y + res)


class SepDepthwisePointwise(nn.Module):
    """``seq``: depthwise (k,1) conv, BN, LeakyReLU(0.01), 1x1, BN, ReLU
    (``DepthWiseSeparableConv_{3x1,1x1}_1x1``, ``musa_model.py:422-458``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.seq = nn.Sequential(
            TemporalConv(in_channels, in_channels, kernel, groups=in_channels),
            BatchNorm(in_channels),
            nn.LeakyReLU(0.01),
            Conv1x1(in_channels, out_channels),
            BatchNorm(out_channels),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seq(x)


class SepTCN(nn.Module):
    """``sep31`` and ``sep11`` separable blocks plus a 1x1 ``shortcut``
    (``musa_model.py:461-474``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        middle = (out_channels - in_channels) // 2 + in_channels
        self.shortcut = Conv1x1(in_channels, out_channels)
        self.sep31 = SepDepthwisePointwise(in_channels, middle, kernel=3)
        self.sep11 = SepDepthwisePointwise(middle, out_channels, kernel=1)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.sep11(self.sep31(x)) + self.shortcut(x)


class ClassificationModule(nn.Module):
    """``seq``: Linear -> LeakyReLU(0.01) -> LayerNorm -> LeakyReLU ->
    Dropout -> Linear (``musa_model.py:476-490``)."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.seq = nn.Sequential(
            nn.Linear(in_features, hidden),
            nn.LeakyReLU(0.01),
            nn.LayerNorm(hidden, eps=1e-5),
            nn.LeakyReLU(0.01),
            Dropout(dropout),
            nn.Linear(hidden, num_classes),
        )

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for layer in self.seq[:4]:
            x = layer(x)
        return self.seq[5](self.seq[4](x, generator))


class _Cnn1x1(nn.Module):
    """The reference ``cnn1x1`` unit: a 1x1 conv under the name ``cnn``."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__()
        self.cnn = Conv1x1(in_channels, out_channels, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn(x)


class _NormData(nn.Module):
    """The reference ``norm_data``: ``bn`` over the flattened (V, C) features
    (``musa_model.py:370-382``)."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, v, c = x.shape
        return self.bn(x.reshape(n, t, v * c)).reshape(n, t, v, c)


class MusaEmbed(nn.Module):
    """Joint embedding ``cnn``: [norm_data] -> 1x1 -> ReLU. With ``norm`` the
    1x1 sits at index 1 (``joint_embed_*.cnn.1.cnn``); the position stream's
    index 0 is the normalisation, the motion stream's an empty slot, as the
    JAX package normalises the positions only."""

    def __init__(self, in_channels: int, out_channels: int, num_joints: int,
                 bias: bool = True, norm: Optional[str] = None):
        super().__init__()
        unit = _Cnn1x1(in_channels, out_channels, bias=bias)
        if norm is None:
            self.cnn = nn.Sequential(unit)
        elif norm == "data":
            self.cnn = nn.Sequential(_NormData(num_joints * in_channels), unit)
        else:
            self.cnn = nn.Sequential(nn.Identity(), unit)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.cnn(x))


class MusaStream(nn.ModuleList):
    """One stream: n_stage x [graph conv -> sep (k=3, s=1) -> sep (k=5, s=2)],
    channels doubling per stage, then the optional ``SepTCN`` tail; indexed
    as the reference's ``nn.Sequential``."""

    def __init__(self, embed_dim: int, n_stage: int, with_tail: bool = True, **common):
        dim = embed_dim
        blocks = []
        for _ in range(n_stage):
            blocks.append(MusaSpatialGraphConv(dim, dim * 2, **common))
            blocks.append(SepTemporalBlock(dim * 2, 3, stride=1, **common))
            blocks.append(SepTemporalBlock(dim * 2, 5, stride=2, **common))
            dim *= 2
        if with_tail:
            blocks.append(SepTCN(dim, dim * 2))
            dim *= 2
        super().__init__(blocks)
        self.out_channels = dim

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for block in self:
            x = block(x, generator)
        return x


class MusaModel(nn.Module):
    """Two-stream (position + motion) DropGraph GCN with the raw-input
    residual (``musa_model.py:492-589``); ``with_tail=False`` is the
    Ablation (``musa_model.py:593-687``). ``forward(skeleton (N,T,V,C),
    sensor=None, generator=None) -> (N, num_classes)``; the sensor stream is
    ignored. ``fused_dropgraph`` only picks an XLA formulation of the same
    DropGraph distribution in the JAX package; it is accepted and changes
    nothing here."""

    def __init__(self, num_classes: int, in_channels: int = 3, num_joints: int = 14,
                 graph_layout: str = "coco_cut", graph_strategy: str = "uniform",
                 embed_dim: int = 64, n_stage: int = 1, act_type: str = "tanh",
                 block_size: int = 41, keep_prob: float = 0.9, edge: bool = True,
                 bias: bool = True, with_tail: bool = True, embed_norm: bool = False,
                 dropout: float = 0.2, fused_dropgraph: bool = False):
        super().__init__()
        self.joint_embed_pos = MusaEmbed(in_channels, embed_dim, num_joints, bias,
                                         norm="data" if embed_norm else None)
        self.joint_embed_mos = MusaEmbed(2, embed_dim, num_joints, bias,
                                         norm="slot" if embed_norm else None)
        common = dict(act_type=act_type, keep_prob=keep_prob, block_size=block_size,
                      edge=edge, bias=bias, graph_layout=graph_layout,
                      graph_strategy=graph_strategy)
        self.stream_pos = MusaStream(embed_dim, n_stage, with_tail, **common)
        self.stream_mot = MusaStream(embed_dim, n_stage, with_tail, **common)
        features = 2 * self.stream_pos.out_channels + in_channels
        self.fc = ClassificationModule(features, num_classes, dropout=dropout)

    def forward(self, skeleton: torch.Tensor, sensor: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pts = skeleton
        mot = pts[:, :-1, :, :2] - pts[:, 1:, :, :2]         # Gen-3 sign: t minus t+1
        res_pos = pts.mean(dim=(1, 2))                       # (N, C) raw residual
        p = self.stream_pos(self.joint_embed_pos(pts), generator).mean(dim=(1, 2))
        m = self.stream_mot(self.joint_embed_mos(mot), generator).mean(dim=(1, 2))
        return self.fc(torch.cat([p, m, res_pos], dim=-1), generator)
