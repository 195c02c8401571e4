"""Plain PyTorch reference of the Gen-3 DropGraph two-stream GCN
(``Multimodal_Fall3/model/musa_model.py:39-687``, ``musa_model.Model`` as
``Multimodal_Fall3/main.py:307-320`` builds it), train mode included.

Written from the published model in its ``(N, C, T, V)`` layout with
``nn.Conv2d``:

* a joint embedding per stream (1x1 conv, ReLU): positions (C channels) and
  motion (the x, y channels of ``x[t] - x[t+1]``);
* per stream and stage, ``SpatialGraphConv`` (1x1 ``gcn``, the contraction
  ``einsum('nctv,cvw->nctw', x, A * edge)`` with the size-1 partition axis
  broadcast over channels, ``bn``; a 1x1 + BN ``residual`` where the width
  changes), then two ``SepTemporal_Block``s (depthwise (k, 1) conv and BN,
  the activation, pointwise 1x1 and BN; the residual ``x``, or a strided 1x1
  + BN at stride 2), k 3 at stride 1 and k 5 at stride 2, the width doubling
  each stage;
* the ``Sep_TCN`` tail: ``sep31`` and ``sep11`` (depthwise (k, 1), BN,
  LeakyReLU, 1x1, BN, ReLU) plus a 1x1 ``shortcut``;
* the mean over frames and joints of each stream, the raw input's mean
  (``res_pos``), and ``Classification_Module``: Linear, LeakyReLU,
  LayerNorm, LeakyReLU, Dropout, Linear.

Every graph and separable block applies DropGraph in train mode, to its main
branch and then to its residual branch, before their sum and the activation:
``Randomized_DropBlock_Ske`` (Bernoulli seeds in proportion to each joint's
mean activity, spread one hop over ``A * edge``, inverted, rescaled), then
``Randomized_DropBlockT_1d`` (Bernoulli frame seeds in proportion to each
frame's activity, widened by a ``block_size`` max-pool, permuted over time
with one permutation for the batch, inverted, rescaled).

Conventions the system under test states and this module keeps (the
configuration file's ``semantics`` names each):

* a train-mode BatchNorm moves its running variance by the *biased* batch
  variance;
* the motion stream is ``x[t] - x[t+1]`` (``musa_model.py:549``, the
  reverse of Gen-2's);
* ``Classification_Module`` and the separable convs use LeakyReLU slope
  0.01; ``activation_factory('leakyrelu')`` has slope 0.2;
* ``drop_block_ske`` divides by ``1 + 1.92`` (``1 + 1.9`` at 20 joints);
* a DropGraph rescale divides by the mask's sum, at least 1.

Draws. The published code draws from torch's global generator; the system
draws every mask from its train state's generator (``torch.Generator`` on
the card, seeded with the configuration's seed). So this module, in train
mode, takes every draw from one generator of its own on the input's device,
made at its first train-mode forward and seeded with the model section's
``train_seed``, in the published order (per block: ``drop_block_ske`` then
``drop_block_t`` on the main branch, then both on the residual; the position
stream before the motion stream; the head's dropout last) and with the
system's calls: ``torch.bernoulli`` on float32 probabilities clamped to
[0, 1], ``torch.randperm(t)``, and ``bernoulli_(1 - p)`` on a float32 tensor
for the head. The probabilities are cast to float32 before each draw, so a
float64 copy of the module draws the masks a float32 one does. A module
built anew starts its generator anew. The eval forward draws nothing.

Parameter and buffer names are the system's state_dict names (the saved
adjacency ``A`` of each block included), so one state_dict serves this
module and the system under test.

Imports nothing but ``torch`` and the benchmark's STGCAN reference (its
BatchNorm and the coco_cut graph).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.stgcan import BatchNorm, spatial_adjacency

# the preset's sizes (configs/presets/musa_harup.yaml) and musa_model.Model's defaults
PUBLISHED = {"embed_dim": 64, "n_stage": 1, "act_type": "tanh", "block_size": 41,
             "keep_prob": 0.9, "edge": True, "bias": True, "dropout": 0.2, "head_hidden": 128}

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "leakyrelu": lambda x: F.leaky_relu(x, 0.2)}


def sizes(model: dict) -> dict:
    """The published sizes with the configuration's ``kwargs`` laid over
    them, and the window's shape."""
    k = {**PUBLISHED, **model.get("kwargs", {})}
    k["head_hidden"] = model.get("head_hidden", k["head_hidden"])
    return {**k, "V": model["num_joints"], "T": model["seq_len"], "C": model["in_channels"],
            "classes": model["num_classes"]}


def uniform_adjacency() -> torch.Tensor:
    """coco_cut's 1-hop graph with self-loops, normalised by column degree
    (``A D^-1``), as one partition ``(1, V, V)``: the ``uniform`` strategy,
    which is the sum of the spatial strategy's three partitions."""
    return torch.tensor(spatial_adjacency().sum(axis=0)[None], dtype=torch.float32)


def _draw(probs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return torch.bernoulli(probs.float().clamp(0.0, 1.0), generator=gen)


def drop_block_ske(x: torch.Tensor, keep_prob: float, A: torch.Tensor,
                   gen: torch.Generator) -> torch.Tensor:
    """``Randomized_DropBlock_Ske`` on ``x`` ``(N, C, T, V)`` with ``A``
    ``(V, V)``."""
    n, _, _, v = x.shape
    act = torch.mean(torch.mean(torch.abs(x.detach()), dim=2), dim=1)      # (N, V)
    act = act / torch.sum(act) * act.numel()
    gamma = (1.0 - keep_prob) / (1.0 + (1.9 if v == 20 else 1.92))
    seed = _draw(act * gamma, gen).to(x.dtype)
    spread = torch.matmul(seed, A.detach())
    mask = 1.0 - (spread > 0.001).to(x.dtype)
    return x * mask.view(n, 1, 1, v) * (mask.numel() / mask.sum().clamp(min=1.0))


def drop_block_t(x: torch.Tensor, keep_prob: float, block_size: int,
                 gen: torch.Generator) -> torch.Tensor:
    """``Randomized_DropBlockT_1d`` on ``x`` ``(N, C, T, V)``."""
    n, _, t, _ = x.shape
    act = torch.mean(torch.mean(torch.abs(x.detach()), dim=3), dim=1)      # (N, T)
    act = act / torch.sum(act) * act.numel()
    seed = _draw(act * ((1.0 - keep_prob) / block_size), gen).to(x.dtype)
    perm = torch.randperm(t, generator=gen, device=x.device)
    widened = F.max_pool1d(seed[:, None], block_size, stride=1, padding=block_size // 2)[:, 0]
    mask = 1.0 - widened[:, perm]
    return x * mask.view(n, 1, t, 1) * (mask.numel() / mask.sum().clamp(min=1.0))


class DropGraphBlock(nn.Module):
    """What the graph conv and the separable blocks share: the saved
    adjacency ``A``, the learnable ``edge`` mask and DropGraph."""

    def __init__(self, s: dict):
        super().__init__()
        self.edge = nn.Parameter(torch.ones(1, s["V"], s["V"])) if s["edge"] else None
        self.register_buffer("A", uniform_adjacency())
        self.act = ACTIVATIONS[s["act_type"]]
        self.keep_prob, self.block_size = s["keep_prob"], s["block_size"]

    def graph(self) -> torch.Tensor:
        return self.A if self.edge is None else self.A * self.edge

    def drop(self, gen: Optional[torch.Generator], *branches):
        if not self.training or self.keep_prob >= 1.0:
            return branches
        A = self.graph()[0]
        return tuple(drop_block_t(drop_block_ske(z, self.keep_prob, A, gen), self.keep_prob,
                                  self.block_size, gen) for z in branches)


def conv_bn(cin: int, cout: int, bias: bool, kernel: int = 1, stride: int = 1,
            groups: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, (kernel, 1), (stride, 1), ((kernel - 1) // 2, 0),
                                   groups=groups, bias=bias), BatchNorm(cout))


class SpatialGraphConv(DropGraphBlock):
    def __init__(self, cin: int, cout: int, s: dict):
        super().__init__(s)
        self.gcn = nn.Conv2d(cin, cout, 1, bias=s["bias"])
        self.bn = BatchNorm(cout)
        self.residual = conv_bn(cin, cout, s["bias"]) if cin != cout else None

    def forward(self, x: torch.Tensor, gen=None) -> torch.Tensor:
        y = self.bn(torch.einsum("nctv,cvw->nctw", self.gcn(x), self.graph()))
        res = x if self.residual is None else self.residual(x)
        y, res = self.drop(gen, y, res)
        return self.act(y + res)


class SepTemporalBlock(DropGraphBlock):
    def __init__(self, channels: int, kernel: int, stride: int, s: dict):
        super().__init__(s)
        self.depth_conv = conv_bn(channels, channels, s["bias"], kernel, stride, channels)
        self.point_conv = conv_bn(channels, channels, s["bias"])
        self.residual = conv_bn(channels, channels, s["bias"], 1, stride) if stride != 1 else None

    def forward(self, x: torch.Tensor, gen=None) -> torch.Tensor:
        y = self.point_conv(self.act(self.depth_conv(x)))
        res = x if self.residual is None else self.residual(x)
        y, res = self.drop(gen, y, res)
        return self.act(y + res)


class SepConv(nn.Module):
    """``DepthWiseSeparableConv``: depthwise (k, 1), BN, LeakyReLU(0.01),
    1x1, BN, ReLU, under the name ``seq``."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.seq = nn.Sequential(*conv_bn(cin, cin, True, kernel, 1, cin), nn.LeakyReLU(0.01),
                                 *conv_bn(cin, cout, True), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seq(x)


class SepTCN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        middle = (cout - cin) // 2 + cin
        self.shortcut = nn.Conv2d(cin, cout, 1)
        self.sep31 = SepConv(cin, middle, 3)
        self.sep11 = SepConv(middle, cout, 1)

    def forward(self, x: torch.Tensor, gen=None) -> torch.Tensor:
        return self.sep11(self.sep31(x)) + self.shortcut(x)


class Embed(nn.Module):
    """``cnn.0.cnn``: the joint embedding's 1x1 conv (ReLU in the forward)."""

    def __init__(self, cin: int, cout: int, bias: bool):
        super().__init__()
        self.cnn = nn.Sequential(nn.Module())
        self.cnn[0].cnn = nn.Conv2d(cin, cout, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.cnn[0].cnn(x))


def stream(s: dict) -> nn.ModuleList:
    dim, blocks = s["embed_dim"], []
    for _ in range(s["n_stage"]):
        blocks += [SpatialGraphConv(dim, 2 * dim, s), SepTemporalBlock(2 * dim, 3, 1, s),
                   SepTemporalBlock(2 * dim, 5, 2, s)]
        dim *= 2
    return nn.ModuleList(blocks + [SepTCN(dim, 2 * dim)])


class Head(nn.Module):
    """``Classification_Module`` under the name ``seq`` (index 4, the
    dropout, holds nothing: it is drawn in :meth:`Model.forward`)."""

    def __init__(self, features: int, hidden: int, classes: int):
        super().__init__()
        self.seq = nn.Sequential(nn.Linear(features, hidden), nn.LeakyReLU(0.01),
                                 nn.LayerNorm(hidden), nn.LeakyReLU(0.01), nn.Identity(),
                                 nn.Linear(hidden, classes))


class Model(nn.Module):
    """``(skeleton (N, T, V, C), sensor) -> logits``; the sensor is not read."""

    def __init__(self, model: dict):
        super().__init__()
        self.s = s = sizes(model)
        self.train_seed = int(model["train_seed"])
        self.generator: Optional[torch.Generator] = None
        self.joint_embed_pos = Embed(s["C"], s["embed_dim"], s["bias"])
        self.joint_embed_mos = Embed(2, s["embed_dim"], s["bias"])
        self.stream_pos = stream(s)
        self.stream_mot = stream(s)
        width = s["embed_dim"] * 2 ** (s["n_stage"] + 1)
        self.fc = Head(2 * width + s["C"], s["head_hidden"], s["classes"])

    def _generator(self, device: torch.device) -> Optional[torch.Generator]:
        if not self.training:
            return None
        if self.generator is None:
            self.generator = torch.Generator(device=device).manual_seed(self.train_seed)
        return self.generator

    def forward(self, skeleton: torch.Tensor, sensor=None) -> torch.Tensor:
        gen = self._generator(skeleton.device)
        x = skeleton.permute(0, 3, 1, 2)                             # (N, C, T, V)
        mot = x[:, :2, :-1] - x[:, :2, 1:]
        res_pos = x.mean(dim=(2, 3))
        pooled = []
        for embed, blocks, z in ((self.joint_embed_pos, self.stream_pos, x),
                                 (self.joint_embed_mos, self.stream_mot, mot)):
            z = embed(z)
            for block in blocks:
                z = block(z, gen)
            pooled.append(z.mean(dim=(2, 3)))
        seq = self.fc.seq
        h = seq[3](seq[2](seq[1](seq[0](torch.cat(pooled + [res_pos], dim=1)))))
        p = self.s["dropout"]
        if gen is not None and p > 0:
            keep = torch.empty(h.shape, dtype=torch.float32, device=h.device)
            h = h * keep.bernoulli_(1.0 - p, generator=gen).to(h.dtype) / (1.0 - p)
        return seq[5](h)


def build(model: dict) -> nn.Module:
    """The configuration file's model (``"model"`` section)."""
    return Model(model)


def raw_leaves(model: nn.Module, scheme: str) -> Iterator[Tuple[torch.Tensor, float, float]]:
    """``(tensor, scale, offset)`` of the learnable ``edge`` masks ``(1, V,
    V)`` of every graph and separable block: ones under ``"init"``, as the
    published constructor makes them, and ``1 + 0.2u`` under ``"trained"``."""
    for name, p in model.named_parameters():
        if name.split(".")[-1] == "edge":
            yield p, (0.0 if scheme == "init" else 0.2), 1.0


def forward_flops(model: dict) -> float:
    """One window's FLOPs through the published forward: every convolution
    and linear layer (twice its multiply-adds; the depthwise convolutions
    ``k`` a channel and position), and each graph conv's contraction with
    ``A * edge`` over the *dense* ``V x V`` adjacency, as the published
    einsum computes it (``2 T C V^2``). Elementwise work, normalisation,
    pooling and DropGraph are not counted."""
    s = sizes(model)
    v, e = s["V"], s["embed_dim"]

    def stream_macs(t: int, cin: int) -> float:
        macs, c = t * v * cin * e, e                                  # embedding
        for _ in range(s["n_stage"]):
            macs += 2 * t * v * c * 2 * c + t * 2 * c * v * v         # gcn, residual, A
            c *= 2
            macs += t * v * c * 3 + t * v * c * c                     # sep k3: depth, point
            t = (t - 1) // 2 + 1
            macs += t * v * c * 5 + 2 * t * v * c * c                 # sep k5 s2 and residual
        middle = c // 2 + c
        macs += t * v * (c * 3 + c * middle + middle + middle * 2 * c + c * 2 * c)
        return macs

    width = e * 2 ** (s["n_stage"] + 1)
    head = (2 * width + s["C"]) * s["head_hidden"] + s["head_hidden"] * s["classes"]
    return 2.0 * (stream_macs(s["T"], s["C"]) + stream_macs(s["T"] - 1, 2) + head)
