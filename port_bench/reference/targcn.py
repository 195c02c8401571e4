"""Plain PyTorch reference of TARGCN (the reference repository's Gen-1
``EmbGCN.py``, ``GRU.py``, ``TA.py`` and ``TRAGCN.py:134-224``, built as
``TARGCN(adj=None)`` by ``TARGCN_HAR_conv_10kfold.ipynb``).

Written from the published equations, in the published ``(B, T, N, C)``
layout, one frame at a time. Every frame recomputes what its graph
convolutions use, as ``EmbGCN.forward`` does on each call:

* the adaptive supports ``I + softmax(relu(E E^T))`` (row softmax);
* the node-wise weights ``einsum('nd,dio->nio', E, weights_pool)`` and
  biases ``E @ bias_pool``;
* the static gated branch ``sigmoid(s) * s``, ``s = linear(x weighted by
  softmax(static))``, added to ``x_g W + b`` (``x_g = supports @ x``);
* the GRU: ``z, r = sigmoid(gate([x, h]))``, ``h_hat = tanh(update([x,
  r h]))``, ``h' = z h + (1 - z) h_hat``, from ``h = 0``, layer by layer.

Then the temporal attention (``TA.py``): the sin/cos ``PE``; per layer, Q
and K from ``Conv2d(T, T, (1, 3))`` over the ``(N, C)`` image with the
frames as channels (valid padding: C - 2 features), softmax over frames of
``Q K^T / sqrt(C)`` with C the full width, values ``vff(x)``, the residual
and ``ln``, ``ff`` (Linear, ReLU, Linear), the residual and ``lnff``. Then
the head: the last ``context_steps`` frames as channels through
``end_conv``, the mean over horizon and nodes, ``fc.2``.

Departures from the published code, none of which changes the function:

* the static adjacency is the all-ones matrix that ``adj=None`` gives
  (``TRAGCN.py:191`` passes ``adj`` only ``if adj != None``), normalised as
  ``EmbGCN.py:14-26`` does: ``W + I/2``, ``D = diag(1/rowsum)``,
  ``sqrt(D) W sqrt(D)``, row softmax;
* the published ``einsum('nm,bmc->bmc', softmax(static), x)`` is written as
  its value, each node's features times the column sum of
  ``softmax(static)``, so that no product over the nodes is computed (or
  counted) where the published expression has none;
* ``fc.0`` and ``fc.1`` (the published pooling slots) hold nothing: the
  mean is taken in ``forward``;
* no dropout (evaluation), and only the ``gated`` graph convolution of the
  published model.

Parameter and buffer names are the system's state_dict names, so one
state_dict serves this module and the system under test.

Imports nothing but ``torch`` and ``numpy``.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

# the preset's sizes (configs/presets/targcn_harup.yaml) and TARGCN's defaults
PUBLISHED = {"rnn_units": 64, "embed_dim": 64, "output_dim": 64, "horizon": 30,
             "num_layers": 2, "context_steps": 6, "gcn_variant": "gated"}


def sizes(model: dict) -> dict:
    """The published sizes with the configuration's ``kwargs`` laid over
    them, and the window's shape."""
    k = {**PUBLISHED, **model.get("kwargs", {})}
    if k["gcn_variant"] != "gated":
        raise ValueError(f"the reference computes the published gated graph convolution, "
                         f"not {k['gcn_variant']!r}")
    return {**k, "V": model["num_joints"], "T": model["seq_len"], "C": model["in_channels"],
            "classes": model["num_classes"]}


def static_support(num_nodes: int) -> torch.Tensor:
    """``EmbGCN.py:14-26`` on the all-ones adjacency of ``adj=None``."""
    w = np.ones((num_nodes, num_nodes)) + 0.5 * np.eye(num_nodes)
    d = np.sqrt(np.diag(1.0 / w.sum(axis=1)))
    return torch.softmax(torch.tensor(d @ w @ d, dtype=torch.float32), dim=1)


class EmbGCN(nn.Module):
    """``EmbGCN.forward`` for one frame ``x`` ``(B, N, I)``."""

    def __init__(self, dim_in: int, dim_out: int, embed_dim: int, num_nodes: int):
        super().__init__()
        self.weights_pool = nn.Parameter(torch.zeros(embed_dim, dim_in, dim_out))
        self.bias_pool = nn.Parameter(torch.zeros(embed_dim, dim_out))
        self.linear = nn.Linear(dim_in, dim_out)
        self.register_buffer("static", static_support(num_nodes), persistent=False)

    def forward(self, x: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
        n = E.shape[0]
        supports = torch.eye(n, dtype=x.dtype, device=x.device) + \
            torch.softmax(torch.relu(E @ E.t()), dim=1)
        weights = torch.einsum("nd,dio->nio", E, self.weights_pool)
        bias = E @ self.bias_pool
        x_g = torch.einsum("nm,bmc->bnc", supports, x)
        out = torch.einsum("bni,nio->bno", x_g, weights) + bias
        s = self.linear(x * torch.softmax(self.static, dim=-1).sum(dim=0)[None, :, None])
        return out + torch.sigmoid(s) * s


class GRUCell(nn.Module):
    """``GRU.py``: the graph-gated GRU cell for one frame."""

    def __init__(self, dim_in: int, hidden: int, embed_dim: int, num_nodes: int):
        super().__init__()
        self.hidden = hidden
        self.gate = EmbGCN(dim_in + hidden, 2 * hidden, embed_dim, num_nodes)
        self.update = EmbGCN(dim_in + hidden, hidden, embed_dim, num_nodes)

    def forward(self, x: torch.Tensor, h: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
        zr = torch.sigmoid(self.gate(torch.cat([x, h], dim=-1), E))
        z, r = zr[..., :self.hidden], zr[..., self.hidden:]
        h_hat = torch.tanh(self.update(torch.cat([x, r * h], dim=-1), E))
        return z * h + (1 - z) * h_hat


class PE(nn.Module):
    """``TA.py``'s positional table, added to ``(B, T, N, F)``."""

    def __init__(self, max_len: int, dim: int):
        super().__init__()
        pe = torch.zeros(max_len, dim)
        position = torch.arange(0, max_len, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * -(np.log(10000.0) / dim))
        pe[:, 0::2] = torch.sin(position * div)
        pe[:, 1::2] = torch.cos(position * div)
        self.register_buffer("pe", pe[None, :, None, :])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[:, :x.shape[1]]


class TALayer(nn.Module):
    """One temporal attention layer of ``TA.py``."""

    def __init__(self, features: int, frames: int):
        super().__init__()
        self.vff = nn.Linear(features, features)
        self.conv1 = nn.Conv2d(frames, frames, (1, 3))
        self.conv2 = nn.Conv2d(frames, frames, (1, 3))
        self.ln = nn.LayerNorm(features)
        self.lnff = nn.LayerNorm(features)
        self.ff = nn.Sequential(nn.Linear(features, features), nn.ReLU(),
                                nn.Linear(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        q = self.conv1(x).permute(0, 2, 1, 3)          # (B, N, T, C-2)
        k = self.conv2(x).permute(0, 2, 3, 1)          # (B, N, C-2, T)
        v = self.vff(x).permute(0, 2, 1, 3)            # (B, N, T, F)
        a = torch.softmax(torch.matmul(q, k) / c ** 0.5, dim=-1)
        out = self.ln(torch.matmul(a, v).permute(0, 2, 1, 3) + x)
        return self.lnff(self.ff(out) + out)


class Encoder(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        h = s["rnn_units"]
        self.dcrnn_cells = nn.ModuleList([
            GRUCell(s["C"] if i == 0 else h, h, s["embed_dim"], s["V"])
            for i in range(s["num_layers"])])
        self.trans_layer_T = nn.Module()
        self.trans_layer_T.PE = PE(s["T"], h)
        self.trans_layer_T.trans_layers = nn.ModuleList([TALayer(h, s["T"]) for _ in range(2)])


class TARGCN(nn.Module):
    """``(skeleton (B, T, N, C), sensor) -> logits``; the sensor is not read."""

    def __init__(self, model: dict):
        super().__init__()
        self.s = s = sizes(model)
        self.node_embeddings = nn.Parameter(torch.zeros(s["V"], s["embed_dim"]))
        self.encoder = Encoder(s)
        self.end_conv = nn.Conv2d(s["context_steps"], s["horizon"] * s["output_dim"],
                                  (1, s["rnn_units"]))
        self.fc = nn.Sequential(nn.Identity(), nn.Identity(),
                                nn.Linear(s["output_dim"], s["classes"]))

    def recurrence(self, x: torch.Tensor) -> torch.Tensor:
        E = self.node_embeddings
        for cell in self.encoder.dcrnn_cells:
            h = x.new_zeros(x.shape[0], x.shape[2], cell.hidden)
            frames = []
            for t in range(x.shape[1]):
                h = cell(x[:, t], h, E)
                frames.append(h)
            x = torch.stack(frames, dim=1)
        return x

    def forward(self, skeleton: torch.Tensor, sensor=None) -> torch.Tensor:
        s, ta = self.s, self.encoder.trans_layer_T
        x = ta.PE(self.recurrence(skeleton))
        for layer in ta.trans_layers:
            x = layer(x)
        out = self.end_conv(x[:, -s["context_steps"]:])            # (B, horizon*F, N, 1)
        out = out[..., 0].reshape(x.shape[0], s["horizon"], s["output_dim"], s["V"])
        return self.fc(out.mean(dim=(1, 3)))


def build(model: dict) -> nn.Module:
    """The configuration file's model (``"model"`` section)."""
    return TARGCN(model)


# Seeded scales of the raw parameters, as half-widths of uniform draws
# (variance a^2 / 3). The published N(0, 1) pools and embeddings give a node
# weights of variance embed_dim x dim_in (about 8 in size at the published
# widths), which saturates sigmoid and tanh and would hide errors, and
# E E^T of order embed_dim, which makes the adaptive supports 2 I.
def raw_leaves(model: nn.Module, scheme: str) -> Iterator[Tuple[torch.Tensor, float, float]]:
    """``(tensor, scale, offset)`` of TARGCN's raw leaves, the same under
    both schemes:

    * ``node_embeddings`` ``(N, D)``: variance 2/D (half-width sqrt(6/D)),
      so that ``E_n . E_n`` is about 2 and ``E_n . E_m`` spreads by
      2/sqrt(D): the row softmax gives a node's own column about a third of
      its weight, neither a mean nor an identity;
    * ``weights_pool`` ``(D, I, O)``: variance 1/(2I) (half-width
      sqrt(3/(2I))), so that a node's weights ``E_n @ pool`` have variance
      1/I, a fan-in draw: the gates' pre-activations keep the size of their
      inputs;
    * ``bias_pool`` ``(D, O)``: variance 1/200 (half-width sqrt(0.015)), so
      that a node's biases spread by 0.1.
    """
    for name, p in model.named_parameters():
        if name == "node_embeddings":
            yield p, (6.0 / p.shape[1]) ** 0.5, 0.0
        elif name.endswith("weights_pool"):
            yield p, (3.0 / (2 * p.shape[1])) ** 0.5, 0.0
        elif name.endswith("bias_pool"):
            yield p, 0.015 ** 0.5, 0.0


def _recurrence_flops(s: dict) -> float:
    """One window's recurrence: per frame and layer, each graph convolution's
    ``supports @ x`` (2 N^2 I), its node-wise product (2 N I O) and its
    static branch's linear (2 N I O), for the gate (O = 2H) and the update
    (O = H)."""
    n, h, total = s["V"], s["rnn_units"], 0.0
    for layer in range(s["num_layers"]):
        i = (s["C"] if layer == 0 else h) + h
        total += 2 * (2 * n * n * i + 2 * n * i * 2 * h + 2 * n * i * h)
    return s["T"] * total


def _weight_generation_flops(s: dict) -> float:
    """One call's generation of the node-wise weights and biases and the
    supports, per graph convolution: ``E E^T`` (2 N^2 D), ``E @ pool``
    (2 N D I O) and ``E @ bias_pool`` (2 N D O)."""
    n, h, d, total = s["V"], s["rnn_units"], s["embed_dim"], 0.0
    for layer in range(s["num_layers"]):
        i = (s["C"] if layer == 0 else h) + h
        for o in (2 * h, h):
            total += 2 * n * n * d + 2 * n * d * i * o + 2 * n * d * o
    return total


def forward_flops(model: dict) -> float:
    """One window's FLOPs through the published forward: the recurrence's
    products (:func:`_recurrence_flops`); per attention layer the two
    ``(1, 3)`` convolutions, ``vff``, ``Q K^T``, ``A V`` and ``ff``;
    ``end_conv``; ``fc``. Elementwise work, softmax, normalisation and
    pooling are not counted. Not counted either: the node-wise weights,
    biases and supports generated from the embeddings, which depend on no
    window, so a call makes them once whatever its batch
    (:func:`_weight_generation_flops`)."""
    s = sizes(model)
    n, t, h = s["V"], s["T"], s["rnn_units"]
    ta = (2 * 2 * t * n * (h - 2) * t * 3     # conv1, conv2
          + 2 * t * n * h * h                 # vff
          + 2 * n * t * t * (h - 2)           # Q K^T
          + 2 * n * t * t * h                 # A V
          + 2 * 2 * t * n * h * h)            # ff
    end_conv = 2 * s["horizon"] * s["output_dim"] * n * s["context_steps"] * h
    fc = 2 * s["output_dim"] * s["classes"]
    return _recurrence_flops(s) + 2 * ta + end_conv + fc


def recurrence_cost(model: dict, batch: int) -> Tuple[float, float]:
    """(FLOPs, least bytes) of one forward's recurrence at ``batch``
    windows: every layer over every frame, with the call's weight generation
    (:func:`_weight_generation_flops`), which the recurrence computes once a
    layer. Bytes: the input windows read once, each layer's hidden states
    written once, the raw weights (embeddings, pools, the static branches'
    linears) read once, in float32."""
    s = sizes(model)
    n, t, h, d = s["V"], s["T"], s["rnn_units"], s["embed_dim"]
    flops = batch * _recurrence_flops(s) + _weight_generation_flops(s)
    weights = n * d
    for layer in range(s["num_layers"]):
        i = (s["C"] if layer == 0 else h) + h
        for o in (2 * h, h):
            weights += d * i * o + d * o + i * o + o
    nbytes = 4.0 * (batch * t * n * s["C"] + s["num_layers"] * batch * t * n * h + weights)
    return flops, nbytes
