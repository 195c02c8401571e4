"""TARGCN in PyTorch: adaptive-adjacency GCNs, a graph-gated GRU and a
temporal-attention transformer, ``(N, T, V, C)`` layout.

Counterpart of ``fall_multimodal_tpu/models/targcn.py`` (reference Gen-1
``EmbGCN.py``, ``GRU.py``, ``TA.py``, ``TRAGCN.py``). Parameter names are the
reference's: ``node_embeddings``;
``encoder.dcrnn_cells.{l}.{gate,update}.{weights_pool,bias_pool,linear}``;
``encoder.trans_layer_T.trans_layers.{i}.{vff,conv1,conv2,ln,lnff,ff.0,ff.2}``
and the positional table ``encoder.trans_layer_T.PE.pe`` (a saved constant,
checked on load); ``end_conv`` (``Conv2d(6, horizon*C, (1, H))``); ``fc.2``.

The recurrence runs as a Python loop over the frames. What does not depend
on the frame (the supports I + softmax(relu(E E^T)), the node-wise weights
and biases pooled from the embeddings, the static column weights) is
computed once per layer (:meth:`GraphGRUCell.prepare`); a step computes
exactly the reference cell. The JAX package's ``fast``, ``precompute_x`` and
``unroll`` choose among XLA formulations of that function; the port takes
them and computes the same function.

The reference's ``adj != None`` quirk (``TRAGCN.py:191``) means it only ever
ran with an all-ones static adjacency: that is the default, with a real
adjacency injectable as ``static_adj``.

Under a profiler a forward records ``targcn.recurrence`` around each
layer's :meth:`GraphGRUCell.scan` (its ``prepare`` included),
``targcn.transformer`` around the temporal transformer and ``targcn.head``
around ``end_conv``, the pool and ``fc``; ``GraphGRUCell.steps`` counts the
frames every scan steps through (:func:`~fall_multimodal_tpu_torch.utils.
profiling.span`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.graphs import embgcn_static_adjacency
from fall_multimodal_tpu_torch.models.layers import DenseConv2d, register_constant
from fall_multimodal_tpu_torch.utils.profiling import span

GCN_VARIANTS = ("gated", "nogate", "linear", "sa")


def _supports(node_emb: torch.Tensor) -> torch.Tensor:
    """I + row-softmax(relu(E E^T)) (``EmbGCN.py:73-75``)."""
    s = torch.softmax(torch.relu(node_emb @ node_emb.t()), dim=1)
    return torch.eye(node_emb.shape[0], dtype=s.dtype, device=s.device) + s


def _static(num_nodes: int, static_adj: Optional[np.ndarray]) -> torch.Tensor:
    adj = np.ones((num_nodes, num_nodes)) if static_adj is None else np.asarray(static_adj)
    return torch.tensor(embgcn_static_adjacency(adj), dtype=torch.float32)


class EmbGCN(nn.Module):
    """Adaptive-adjacency graph conv (``EmbGCN.py:59-109``): node-wise weights
    ``E @ weights_pool`` and biases ``E @ bias_pool`` over ``supports @ x``,
    plus, when ``gate``, the static branch ``sigmoid(s) * s`` with
    ``s = linear(x * w)``, ``w`` being the column sums of softmax(static) —
    the reference's ``einsum('nm,bmc->bmc')`` weighs each node by its column,
    it does not mix nodes."""

    def __init__(self, dim_in: int, dim_out: int, embed_dim: int, num_nodes: int,
                 static_adj: Optional[np.ndarray] = None, gate: bool = True):
        super().__init__()
        self.weights_pool = nn.Parameter(torch.zeros(embed_dim, dim_in, dim_out))
        self.bias_pool = nn.Parameter(torch.zeros(embed_dim, dim_out))
        self.linear = nn.Linear(dim_in, dim_out) if gate else None
        col = torch.softmax(_static(num_nodes, static_adj), dim=-1).sum(dim=0)
        self.register_buffer("col_weight", col, persistent=False)

    def prepare(self, node_emb: torch.Tensor):
        """What a frame does not change: (supports, weights, bias)."""
        return (_supports(node_emb),
                torch.einsum("nd,dio->nio", node_emb, self.weights_pool),
                node_emb @ self.bias_pool)

    def step(self, x: torch.Tensor, prepared) -> torch.Tensor:
        supports, weights, bias = prepared
        x_g = torch.einsum("nm,bmc->bnc", supports, x)
        out = torch.einsum("bni,nio->bno", x_g, weights) + bias
        if self.linear is not None:
            s = self.linear(x * self.col_weight[None, :, None])
            out = out + torch.sigmoid(s) * s
        return out

    def forward(self, x: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
        return self.step(x, self.prepare(node_emb))


class EmbGCNLinear(nn.Module):
    """``supports @ x`` -> ``linear`` (``EmbGCN.py:111-124``)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.linear = nn.Linear(dim_in, dim_out)

    def prepare(self, node_emb: torch.Tensor):
        return _supports(node_emb)

    def step(self, x: torch.Tensor, supports) -> torch.Tensor:
        return self.linear(torch.einsum("nm,bmc->bnc", supports, x))

    def forward(self, x: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
        return self.step(x, self.prepare(node_emb))


class SpatialAttention(nn.Module):
    """Adjacency-modulated spatial attention (``EmbGCN.py:27-58``): the
    softmax of ``wq(x) wk(x)^T`` over the query axis, through the static
    support, applied to ``wv(x)``."""

    def __init__(self, dim_in: int, dim_out: int, num_nodes: int,
                 static_adj: Optional[np.ndarray] = None):
        super().__init__()
        self.wq = nn.Linear(dim_in, dim_out)
        self.wk = nn.Linear(dim_in, dim_out)
        self.wv = nn.Linear(dim_in, dim_out, bias=False)
        self.register_buffer("static", _static(num_nodes, static_adj), persistent=False)

    def prepare(self, node_emb: torch.Tensor):
        return None

    def step(self, x: torch.Tensor, prepared=None) -> torch.Tensor:
        score = torch.softmax(self.wq(x) @ self.wk(x).transpose(1, 2), dim=1)
        score = torch.einsum("bnm,mc->bnc", score, self.static)
        return torch.relu(torch.einsum("bnm,bmc->bnc", score, self.wv(x)))

    def forward(self, x: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
        return self.step(x)


class GraphGRUCell(nn.Module):
    """Graph GRU cell with graph-conv ``gate`` and ``update`` transforms
    (``GRU.py:8-30``): z, r = sigmoid(gate([x, h])); h_hat = tanh(update([x,
    r*h])); h' = z*h + (1-z)*h_hat. ``gcn_variant``: gated | nogate | linear
    | sa. ``GraphGRUCell.steps`` counts the frames :meth:`scan` steps
    through, in every cell."""

    steps = 0

    def __init__(self, dim_in: int, hidden_dim: int, embed_dim: int, num_nodes: int,
                 static_adj: Optional[np.ndarray] = None, gcn_variant: str = "gated"):
        super().__init__()
        if gcn_variant not in GCN_VARIANTS:
            raise ValueError(f"gcn_variant must be one of {GCN_VARIANTS}, got {gcn_variant!r}")
        self.hidden_dim = hidden_dim

        def gcn(dim_out):
            if gcn_variant == "linear":
                return EmbGCNLinear(dim_in + hidden_dim, dim_out)
            if gcn_variant == "sa":
                return SpatialAttention(dim_in + hidden_dim, dim_out, num_nodes, static_adj)
            return EmbGCN(dim_in + hidden_dim, dim_out, embed_dim, num_nodes, static_adj,
                          gate=gcn_variant == "gated")

        self.gate = gcn(2 * hidden_dim)
        self.update = gcn(hidden_dim)

    def prepare(self, node_emb: torch.Tensor):
        return self.gate.prepare(node_emb), self.update.prepare(node_emb)

    def step(self, x: torch.Tensor, h: torch.Tensor, prepared) -> torch.Tensor:
        gate_c, update_c = prepared
        z, r = torch.sigmoid(self.gate.step(torch.cat([x, h], dim=-1), gate_c)).chunk(2, dim=-1)
        h_hat = torch.tanh(self.update.step(torch.cat([x, r * h], dim=-1), update_c))
        return z * h + (1.0 - z) * h_hat

    def forward(self, x: torch.Tensor, h: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
        return self.step(x, h, self.prepare(node_emb))

    def scan(self, xs: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
        """The cell over every frame of ``xs`` (B, T, V, C) from h = 0:
        (B, T, V, H)."""
        b, t, v, _ = xs.shape
        GraphGRUCell.steps += t
        with span("targcn.recurrence"):
            prepared = self.prepare(node_emb)
            h = xs.new_zeros(b, v, self.hidden_dim)
            out = []
            for i in range(t):
                h = self.step(xs[:, i], h, prepared)
                out.append(h)
            return torch.stack(out, dim=1)


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """The sin/cos table (``TA.py:72-90``): (1, T, 1, F)."""
    pe = np.zeros((max_len, dim), np.float32)
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe[None, :, None, :]


class PositionalEncoding(nn.Module):
    """Adds the saved ``pe`` table (a constant, checked on load)."""

    def __init__(self, max_len: int, dim: int):
        super().__init__()
        register_constant(self, "pe", torch.from_numpy(sinusoidal_positions(max_len, dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[:, : x.shape[1]]


class TemporalTransformLayer(nn.Module):
    """One TA layer (``TA.py:22-69``): ``conv1``/``conv2`` give Q and K as
    ``Conv2d(T, T, (1, 3))`` over (V, C) with T as channels (valid padding:
    C shrinks by 2); attention over time per node, scaled by sqrt(C) of the
    full width; ``vff`` values; residual, ``ln``, ``ff``, ``lnff``."""

    def __init__(self, features: int, seq_len: int = 30):
        super().__init__()
        self.vff = nn.Linear(features, features)
        self.conv1 = nn.Conv2d(seq_len, seq_len, (1, 3))
        self.conv2 = nn.Conv2d(seq_len, seq_len, (1, 3))
        self.ln = nn.LayerNorm(features, eps=1e-5)
        self.lnff = nn.LayerNorm(features, eps=1e-5)
        self.ff = nn.Sequential(nn.Linear(features, features), nn.ReLU(),
                                nn.Linear(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        # x (B, T, V, C) read as NCHW: T channels over a (V, C) image
        q = self.conv1(x).transpose(1, 2)                    # (B, V, T, C-2)
        k = self.conv2(x).permute(0, 2, 3, 1)                # (B, V, C-2, T)
        val = self.vff(x).transpose(1, 2)                    # (B, V, T, F)
        attn = torch.softmax((q @ k) / (c ** 0.5), dim=-1)
        out = self.ln((attn @ val).transpose(1, 2) + x)
        return self.lnff(self.ff(out) + out)


class TemporalTransformer(nn.Module):
    """``PE`` + ``trans_layers`` (``TA.py:92-108``)."""

    def __init__(self, features: int, num_layers: int = 2, max_len: int = 30):
        super().__init__()
        self.PE = PositionalEncoding(max_len, features)
        self.trans_layers = nn.ModuleList(
            [TemporalTransformLayer(features, max_len) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.PE(x)
        for layer in self.trans_layers:
            x = layer(x)
        return x


class GraphGRUEncoder(nn.Module):
    """Stacked graph-GRU layers over time (:meth:`recurrence`) and the
    temporal transformer that :meth:`TARGCN.forward` runs after them
    (``TRAGCN.py:134-169``)."""

    def __init__(self, in_channels: int, hidden_dim: int, embed_dim: int, num_nodes: int,
                 seq_len: int, num_layers: int = 2, static_adj=None,
                 gcn_variant: str = "gated"):
        super().__init__()
        self.dcrnn_cells = nn.ModuleList([
            GraphGRUCell(in_channels if i == 0 else hidden_dim, hidden_dim, embed_dim,
                         num_nodes, static_adj, gcn_variant)
            for i in range(num_layers)])
        self.trans_layer_T = TemporalTransformer(hidden_dim, num_layers=2, max_len=seq_len)

    def recurrence(self, x: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
        """The graph-GRU layers alone: (B, T, V, C) -> (B, T, V, H)."""
        for cell in self.dcrnn_cells:
            x = cell.scan(x, node_emb)
        return x


class TARGCN(nn.Module):
    """Graph-GRU encoder -> temporal transformer -> the last
    ``context_steps`` frames through ``end_conv`` -> mean over (horizon, V)
    -> ``fc.2`` (``TRAGCN.py:177-224``). ``forward(skeleton (B,T,V,C),
    sensor=None, generator=None)``; draws nothing, so ``generator`` is
    unused; T must equal ``seq_len`` (the TA convs take T as channels)."""

    def __init__(self, num_classes: int = 11, num_nodes: int = 14, in_channels: int = 3,
                 seq_len: int = 30, rnn_units: int = 64, output_dim: int = 64,
                 horizon: int = 30, num_layers: int = 2, embed_dim: int = 64,
                 static_adj: Optional[np.ndarray] = None, gcn_variant: str = "gated",
                 context_steps: int = 6, fast: bool = True, precompute_x="auto",
                 unroll: int = 1):
        super().__init__()
        self.seq_len = seq_len
        self.horizon, self.output_dim = horizon, output_dim
        self.context_steps = context_steps
        self.node_embeddings = nn.Parameter(torch.zeros(num_nodes, embed_dim))
        self.encoder = GraphGRUEncoder(in_channels, rnn_units, embed_dim, num_nodes, seq_len,
                                       num_layers, static_adj, gcn_variant)
        self.end_conv = DenseConv2d(context_steps, horizon * output_dim, (1, rnn_units))
        # fc.0 / fc.1 are the reference's pooling slots; the mean is taken in forward
        self.fc = nn.Sequential(nn.Identity(), nn.Identity(), nn.Linear(output_dim, num_classes))

    def forward(self, skeleton: torch.Tensor, sensor: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if skeleton.shape[1] != self.seq_len:
            raise ValueError(f"TARGCN takes windows of T={self.seq_len} frames (its temporal "
                             f"attention convolves over T), got T={skeleton.shape[1]}")
        out = self.encoder.recurrence(skeleton, self.node_embeddings)
        with span("targcn.transformer"):
            out = self.encoder.trans_layer_T(out)
        with span("targcn.head"):
            last = out[:, -self.context_steps:]                  # (B, 6, V, H) as NCHW
            pred = self.end_conv(last)[..., 0].transpose(1, 2)   # (B, V, horizon*C)
            b, v, _ = pred.shape
            pooled = pred.reshape(b, v, self.horizon, self.output_dim).mean(dim=(1, 2))
            return self.fc(pooled)
