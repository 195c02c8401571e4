"""Skeleton transformer in PyTorch: spatial and temporal relative-position
multi-head self-attention, layout ``(N, [M,] T, V, C)``.

Counterpart of ``fall_multimodal_tpu/models/skeleton_transformer.py``
(reference ``skeleton_transformer.py:100-514``): a joint embedding MLP, a
stack of B2T ("bottom-to-top residual") blocks that attend over the joints,
then over the frames, then apply an FFN, with stochastic depth ramping
0 -> 0.5 across the blocks, and a pooled 1x1 head; the factorised Ablation1
(single-axis B2T blocks: all spatial, then all temporal ones). The
reference's other blocks, which no registered model builds, are here as
well: the pre-norm block, the parallel spatial+temporal block, the
DenseNet-style growth block, and the B2T block with LayerNorms.

Parameter names are the reference's: ``embedding.{0,2}``;
``extractor.{i}.multi_head_{spatial,temporal}_self_attention.{w_qkv,merge,
relative_position_bias_table}``; ``norm1..3`` (BatchNorm3d in the reference:
here the port's last-axis ``BatchNorm``, whose running variance is biased as
flax's); ``feed_forward_network.{0,2}``; ``fcn.0``. In Ablation1
``extractor.{n/2}`` is the parameterless transpose between the halves.

Stochastic depth and the FFN's dropout draw from the ``generator`` a
train-mode forward is given.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.models.layers import (
    BatchNorm,
    Conv1x1,
    Dropout,
    require_generator,
)


class RelPosMHSA(nn.Module):
    """Relative-position MHSA over axis -2 (x (..., L, C)) or -3 (x (..., L,
    V, C), V untouched) (``skeleton_transformer.py:100-157``). The learnable
    ``relative_position_bias_table`` (2·seq_len-1, head_dim) is indexed by
    ``i - j + seq_len - 1`` and enters the logits as ``q · table[rel]``; the
    content logits are scaled by E^-0.5, the positional term is not."""

    def __init__(self, in_channels: int, head_dim: int = 16, n_heads: int = 8,
                 seq_len: int = 32, axis: int = -2):
        super().__init__()
        if axis not in (-2, -3):
            raise ValueError(f"axis must be -2 or -3, got {axis}")
        self.head_dim, self.n_heads, self.seq_len, self.axis = head_dim, n_heads, seq_len, axis
        e = head_dim * n_heads
        self.w_qkv = nn.Linear(in_channels, 3 * e)
        self.merge = nn.Linear(e, in_channels)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(2 * seq_len - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis == -3:
            return self._attend(x.transpose(-3, -2)).transpose(-3, -2)
        return self._attend(x)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        *lead, length, _ = x.shape
        h, hd = self.n_heads, self.head_dim
        e = h * hd
        q, k, v = (z.reshape(*lead, length, h, hd).transpose(-3, -2)       # (..., H, L, HD)
                   for z in self.w_qkv(x).chunk(3, dim=-1))
        idx = torch.arange(length, device=x.device)
        pos_tab = self.relative_position_bias_table[idx[:, None] - idx[None, :]
                                                    + self.seq_len - 1]   # (L, L, HD)
        logits = (q @ k.transpose(-1, -2)) * (e ** -0.5)
        logits = logits + torch.einsum("...id,ijd->...ij", q, pos_tab)
        out = torch.softmax(logits, dim=-1) @ v                             # (..., H, L, HD)
        return self.merge(out.transpose(-3, -2).reshape(*lead, length, e))


def stochastic_depth(x: torch.Tensor, rate: float, training: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Batch-mode stochastic depth (torchvision semantics,
    ``skeleton_transformer.py:226``): in training the whole branch is dropped
    with probability ``rate``, else scaled by 1/(1-rate)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    gate = torch.bernoulli(torch.full((), keep, device=x.device),
                           generator=require_generator(generator))
    return x * (gate / keep).to(x.dtype)


class FFN(nn.Sequential):
    """Linear -> exact GELU -> Linear -> Dropout, as the reference's
    ``feed_forward_network`` (indices 0-3)."""

    def __init__(self, channels: int, expand: float = 4.0, dropout: float = 0.5):
        hidden = int(channels * expand)
        super().__init__(nn.Linear(channels, hidden), nn.GELU(), nn.Linear(hidden, channels),
                         Dropout(dropout))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self[3](self[2](self[1](self[0](x))), generator)


def _norm(kind: str, channels: int) -> Union[BatchNorm, nn.LayerNorm]:
    """``"batchnorm"`` (the reference's BatchNorm3d over the (N, M, T, V)
    rows) or ``"layernorm"`` over the channels."""
    if kind == "batchnorm":
        return BatchNorm(channels)
    if kind == "layernorm":
        return nn.LayerNorm(channels, eps=1e-5)
    raise ValueError(f"normalization must be batchnorm|layernorm, got {kind!r}")


class B2TSpatialTemporalBlock(nn.Module):
    """Spatial MHSA -> temporal MHSA -> FFN, each branch through stochastic
    depth and a norm (``normalization``: ``"batchnorm"``, as every
    registered model builds it, or ``"layernorm"``), and the B2T residual
    back to the block's input (``skeleton_transformer.py:229-248``)."""

    def __init__(self, channels: int, head_dim: int, n_heads: int, n_joints: int,
                 seq_len: int, ffn_expand: float = 4.0, ffn_dropout: float = 0.5,
                 normalization: str = "batchnorm", sd_rate: float = 0.0,
                 attn_impl: str = "resident"):
        super().__init__()
        if attn_impl not in ("resident", "swap"):
            raise ValueError(f"attn_impl must be resident|swap, got {attn_impl!r}")
        self.sd_rate = sd_rate
        self.multi_head_spatial_self_attention = RelPosMHSA(channels, head_dim, n_heads,
                                                            n_joints)
        self.norm1 = _norm(normalization, channels)
        self.multi_head_temporal_self_attention = RelPosMHSA(channels, head_dim, n_heads,
                                                             seq_len, axis=-3)
        self.norm2 = _norm(normalization, channels)
        self.feed_forward_network = FFN(channels, ffn_expand, ffn_dropout)
        self.norm3 = _norm(normalization, channels)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        def sd(y):
            return stochastic_depth(y, self.sd_rate, self.training, generator)

        out = self.norm1(x + sd(self.multi_head_spatial_self_attention(x)))
        out = self.norm2(out + sd(self.multi_head_temporal_self_attention(out)))
        out = out + sd(self.feed_forward_network(out, generator))
        return self.norm3(x + out)


class B2TBlock(nn.Module):
    """Single-axis B2T block (``skeleton_transformer.py:291-320``): MHSA over
    axis -2 (the reference names it ``multi_head_spatial_self_attention``
    in the temporal half too), ``norm1``, FFN, the B2T residual, ``norm3``."""

    def __init__(self, channels: int, head_dim: int, n_heads: int, attn_len: int,
                 ffn_expand: float = 4.0, ffn_dropout: float = 0.5):
        super().__init__()
        self.multi_head_spatial_self_attention = RelPosMHSA(channels, head_dim, n_heads,
                                                            attn_len)
        self.norm1 = nn.LayerNorm(channels, eps=1e-5)
        self.feed_forward_network = FFN(channels, ffn_expand, ffn_dropout)
        self.norm3 = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        out = self.norm1(x + self.multi_head_spatial_self_attention(x))
        out = out + self.feed_forward_network(out, generator)
        return self.norm3(x + out)


class PreNormBlock(nn.Module):
    """Pre-norm spatial+temporal block (``skeleton_transformer.py:159-200``):
    a LayerNorm before the spatial MHSA, the temporal MHSA and the FFN, plain
    residuals around the two attentions, and ``norm4`` applied to the FFN's
    output: the reference returns the normalised branch, not the residual
    sum."""

    def __init__(self, channels: int, head_dim: int, n_heads: int, n_joints: int,
                 seq_len: int, ffn_expand: float = 4.0, ffn_dropout: float = 0.5):
        super().__init__()
        self.norm1 = nn.LayerNorm(channels, eps=1e-5)
        self.multi_head_spatial_self_attention = RelPosMHSA(channels, head_dim, n_heads,
                                                            n_joints)
        self.norm2 = nn.LayerNorm(channels, eps=1e-5)
        self.multi_head_temporal_self_attention = RelPosMHSA(channels, head_dim, n_heads,
                                                             seq_len, axis=-3)
        self.norm3 = nn.LayerNorm(channels, eps=1e-5)
        self.feed_forward_network = FFN(channels, ffn_expand, ffn_dropout)
        self.norm4 = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = x + self.multi_head_spatial_self_attention(self.norm1(x))
        x = x + self.multi_head_temporal_self_attention(self.norm2(x))
        return self.norm4(self.feed_forward_network(self.norm3(x), generator))


class ParallelB2TBlock(nn.Module):
    """Spatial and temporal MHSA side by side on the block's input, then
    ``norm1``, the FFN, the B2T residual and ``norm3``
    (``skeleton_transformer.py:253-286``)."""

    def __init__(self, channels: int, head_dim: int, n_heads: int, n_joints: int,
                 seq_len: int, ffn_expand: float = 4.0, ffn_dropout: float = 0.5):
        super().__init__()
        self.multi_head_spatial_self_attention = RelPosMHSA(channels, head_dim, n_heads,
                                                            n_joints)
        self.multi_head_temporal_self_attention = RelPosMHSA(channels, head_dim, n_heads,
                                                             seq_len, axis=-3)
        self.norm1 = nn.LayerNorm(channels, eps=1e-5)
        self.feed_forward_network = FFN(channels, ffn_expand, ffn_dropout)
        self.norm3 = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        out = self.norm1(x + self.multi_head_spatial_self_attention(x)
                         + self.multi_head_temporal_self_attention(x))
        out = out + self.feed_forward_network(out, generator)
        return self.norm3(x + out)


class GrowthBlock(nn.Module):
    """DenseNet-style growth (``skeleton_transformer.py:322-348``): a spatial
    B2T ``block``, then ``growth`` (Linear to ``growth`` channels, exact
    GELU, LayerNorm), concatenated to the input: C -> C + growth
    channels."""

    def __init__(self, channels: int, head_dim: int, n_heads: int, n_joints: int,
                 seq_len: int, growth: int = 16):
        super().__init__()
        self.block = B2TBlock(channels, head_dim, n_heads, n_joints)
        self.growth = nn.Sequential(nn.Linear(channels, growth), nn.GELU(),
                                    nn.LayerNorm(growth, eps=1e-5))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return torch.cat([x, self.growth(self.block(x, generator))], dim=-1)


class TransposeAxis(nn.Module):
    """Ablation1's parameterless ``extractor.{n/2}``: swaps T and V."""

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return x.transpose(-3, -2)


class SkeletonTransformer(nn.Module):
    """``embedding`` MLP -> ``extractor`` blocks -> mean over (T, V) and the
    persons -> ``fcn.0`` 1x1 head (``skeleton_transformer.py:360-514``).
    ``forward(skeleton (N,T,V,C) or (N,M,T,V,C), sensor=None,
    generator=None)``; the sensor stream is ignored.

    ``factorized`` builds Ablation1: ``n_block/2`` spatial B2T blocks, the
    transpose, ``n_block/2`` temporal ones. ``attn_impl`` chooses a layout of
    the temporal attention in the JAX package; the port takes it and
    computes the same function."""

    def __init__(self, num_classes: int, in_channels: int = 3, n_joints: int = 14,
                 seq_len: int = 30, embedding_dim: int = 32, n_block: int = 6,
                 head_dim: int = 16, n_heads: int = 8, factorized: bool = False,
                 attn_impl: str = "resident"):
        super().__init__()
        e = embedding_dim
        self.embedding = nn.Sequential(nn.Linear(in_channels, e // 2), nn.GELU(),
                                       nn.Linear(e // 2, e), nn.GELU())
        if factorized:
            half = n_block // 2
            blocks = ([B2TBlock(e, head_dim, n_heads, n_joints) for _ in range(half)]
                      + [TransposeAxis()]
                      + [B2TBlock(e, head_dim, n_heads, seq_len) for _ in range(half)])
        else:
            blocks = [B2TSpatialTemporalBlock(e, head_dim, n_heads, n_joints, seq_len,
                                              sd_rate=float(rate), attn_impl=attn_impl)
                      for rate in np.linspace(0.0, 0.5, n_block)]
        self.extractor = nn.ModuleList(blocks)
        self.fcn = nn.Sequential(Conv1x1(e, num_classes))

    def forward(self, skeleton: torch.Tensor, sensor: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.embedding(skeleton)
        for block in self.extractor:
            y = block(y, generator)
        y = y.mean(dim=(-3, -2))             # over (T, V), in either order
        if skeleton.dim() == 5:
            y = y.mean(dim=1)                # over the persons M
        return self.fcn(y)
