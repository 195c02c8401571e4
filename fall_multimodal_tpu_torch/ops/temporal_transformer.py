"""TARGCN's temporal transformer in one kernel launch (K3): packing, plain
version, CUDA wrapper.

The kernel (``csrc/temporal_transformer.cu``) runs
:class:`~fall_multimodal_tpu_torch.models.targcn.TemporalTransformer`'s
eval forward, the positional table and every TA layer, over each (b, v)
sequence of ``x (B, T, V, F)`` in one launch: ``x`` is read once and the
result written once. It replaces no TPU kernel (the JAX package runs TARGCN
through XLA).

:func:`pack_temporal_transformer` lays the layers' weights out once as the
kernel reads them (frames padded to :data:`MAX_T`, padded rows; the layout
of :func:`layer_layout`). :func:`temporal_transformer_reference` computes
the function from that packed layout in plain PyTorch, for any ``T <=
MAX_T`` and width. :func:`fused_temporal_transformer` runs it for a CPU
tensor and the CUDA kernel for a CUDA tensor, which takes ``F == WIDTH``
and at most :data:`MAX_LAYERS` layers (:func:`kernel_takes`); every launch
adds one to ``fused_temporal_transformer.launches``. The kernel multiplies
in split TF32 (float32 accuracy). :class:`FusedTemporalTransformer` is the
module that serves a transformer this way.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fall_multimodal_tpu_torch.ops import build

MAX_T = 32        # kT of csrc/temporal_transformer.cu: frames, padded
WIDTH = 64        # kF: the feature width the kernel is built for
MAX_LAYERS = 2    # kMaxLayers: layers whose weights shared memory holds
TAPS = 3          # the convolutions' kernel width over the features
EPS = 1e-5        # both LayerNorms'


def layer_layout(f: int) -> Tuple[Dict[str, Tuple[int, Tuple[int, int]]], int]:
    """``({name: (offset, (rows, row stride))}, floats)`` of one packed layer
    of width ``f``: the offsets of the kernel's ``kWq`` .. ``kLnffB``. The
    convolutions ``wq``/``wk`` are ``[t_out][tap * MAX_T + t_in]``; ``wv``,
    ``w1``, ``w2`` the ``nn.Linear`` weights ``[out][in]``; then the biases
    and the two LayerNorms' weights and biases, one row each."""
    conv_ld, lin_ld = TAPS * MAX_T + 4, f + 4
    parts = [("wq", MAX_T, conv_ld), ("wk", MAX_T, conv_ld), ("wv", f, lin_ld),
             ("w1", f, lin_ld), ("w2", f, lin_ld), ("bq", 1, MAX_T), ("bk", 1, MAX_T),
             ("bv", 1, f), ("b1", 1, f), ("b2", 1, f), ("ln_w", 1, f), ("ln_b", 1, f),
             ("lnff_w", 1, f), ("lnff_b", 1, f)]
    layout, off = {}, 0
    for name, rows, ld in parts:
        layout[name] = (off, (rows, ld))
        off += rows * ld
    return layout, off


class PackedTransformer(NamedTuple):
    """What the kernel reads of a temporal transformer, built once by
    :func:`pack_temporal_transformer`; the kernel reads the tensors through
    raw pointers, so they stay alive as long as this tuple."""

    weights: torch.Tensor   # (n_layers * layer floats,) in layer_layout(f)
    pe: torch.Tensor        # (t, f) the positional table's first t rows
    t: int                  # frames (the convolutions' channels)
    f: int                  # feature width
    n_layers: int


def kernel_takes(transformer) -> bool:
    """Whether the CUDA kernel takes this ``TemporalTransformer``: T <= 32
    frames, width 64, at most two layers."""
    layers = transformer.trans_layers
    return (0 < len(layers) <= MAX_LAYERS and layers[0].conv1.in_channels <= MAX_T
            and layers[0].vff.in_features == WIDTH)


@torch.no_grad()
def pack_temporal_transformer(transformer) -> PackedTransformer:
    """Pack a ``TemporalTransformer`` (eval semantics; no dropout) on the
    device its weights are on. Raises ``ValueError`` for more than
    :data:`MAX_T` frames."""
    layers = transformer.trans_layers
    t, f = layers[0].conv1.in_channels, layers[0].vff.in_features
    if t > MAX_T:
        raise ValueError(f"the packed layout holds at most {MAX_T} frames, got T={t}")
    layout, floats = layer_layout(f)
    dev = layers[0].vff.weight.device
    weights = torch.zeros(len(layers) * floats, dtype=torch.float32, device=dev)
    for i, layer in enumerate(layers):
        p = _unpack(weights[i * floats: (i + 1) * floats], layout, t, f)
        p["wq"].copy_(layer.conv1.weight[:, :, 0, :].permute(0, 2, 1))   # (t_out, tap, t_in)
        p["wk"].copy_(layer.conv2.weight[:, :, 0, :].permute(0, 2, 1))
        for name, mod in (("v", layer.vff), ("1", layer.ff[0]), ("2", layer.ff[2])):
            p[f"w{name}"].copy_(mod.weight)
            p[f"b{name}"].copy_(mod.bias)
        p["bq"].copy_(layer.conv1.bias)
        p["bk"].copy_(layer.conv2.bias)
        for name, mod in (("ln", layer.ln), ("lnff", layer.lnff)):
            p[f"{name}_w"].copy_(mod.weight)
            p[f"{name}_b"].copy_(mod.bias)
    pe = transformer.PE.pe[0, :t, 0, :].to(device=dev, dtype=torch.float32).contiguous()
    return PackedTransformer(weights, pe, t, f, len(layers))


def _unpack(buf: torch.Tensor, layout, t: int, f: int) -> Dict[str, torch.Tensor]:
    """Views of one packed layer's valid entries (pads left out)."""
    out = {}
    for name, (off, (rows, ld)) in layout.items():
        block = buf[off: off + rows * ld].view(rows, ld)
        if name in ("wq", "wk"):
            out[name] = block[:t, :TAPS * MAX_T].view(t, TAPS, MAX_T)[:, :, :t]
        elif rows == 1:
            out[name] = block[0, : (t if name in ("bq", "bk") else f)]
        else:
            out[name] = block[:, :f]
    return out


def temporal_transformer_reference(x: torch.Tensor, packed: PackedTransformer) -> torch.Tensor:
    """Plain PyTorch version of the kernel, from the packed weights:
    ``x (B, T, V, F) -> (B, T, V, F)``, the positional table added, then
    each TA layer (``TemporalTransformLayer.forward``) over the T frames of
    each (b, v) sequence."""
    b, t, v, f = x.shape
    layout, floats = layer_layout(f)
    h = (x + packed.pe[:, None, :]).permute(0, 2, 1, 3).reshape(b * v, t, f)
    for i in range(packed.n_layers):
        p = _unpack(packed.weights[i * floats: (i + 1) * floats], layout, t, f)
        shifted = torch.stack([h[:, :, k: k + f - 2] for k in range(TAPS)], dim=1)
        q = torch.einsum("okt,nktc->noc", p["wq"], shifted) + p["bq"][:, None]
        k = torch.einsum("okt,nktc->noc", p["wk"], shifted) + p["bk"][:, None]
        attn = torch.softmax((q @ k.transpose(1, 2)) / (f ** 0.5), dim=-1)
        out = F.layer_norm(attn @ F.linear(h, p["wv"], p["bv"]) + h, (f,), p["ln_w"],
                           p["ln_b"], EPS)
        ff = F.linear(torch.relu(F.linear(out, p["w1"], p["b1"])), p["w2"], p["b2"])
        h = F.layer_norm(ff + out, (f,), p["lnff_w"], p["lnff_b"], EPS)
    return h.reshape(b, v, t, f).permute(0, 2, 1, 3).contiguous()


_bound_lib = None


def _kernel():
    """The bound C entry points of ``csrc/temporal_transformer.cu``."""
    global _bound_lib
    if _bound_lib is None:
        lib = build.load("temporal_transformer")
        fn = lib.temporal_transformer_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.temporal_transformer_layer_floats.argtypes = []
        lib.temporal_transformer_layer_floats.restype = ctypes.c_int
        lib.temporal_transformer_error_string.argtypes = [ctypes.c_int]
        lib.temporal_transformer_error_string.restype = ctypes.c_char_p
        if lib.temporal_transformer_layer_floats() != layer_layout(WIDTH)[1]:
            raise RuntimeError("csrc/temporal_transformer.cu and layer_layout disagree on "
                               "the packed layer's size")
        _bound_lib = lib
    return _bound_lib


def fused_temporal_transformer(x: torch.Tensor, packed: PackedTransformer) -> torch.Tensor:
    """The temporal transformer packed in ``packed`` over ``x (B, T, V, F)``.

    A CPU tensor goes through :func:`temporal_transformer_reference`; a CUDA
    tensor through the CUDA kernel, one launch whatever B, built at first
    use. ``packed`` must lie on ``x``'s device. Every launch adds one to
    ``fused_temporal_transformer.launches``.
    """
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "x must be a contiguous float32 (B, T, V, F) tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})")
    b, t, v, f = x.shape
    if (t, f) != (packed.t, packed.f) or packed.weights.device != x.device:
        raise ValueError(f"x has (T, F) = {(t, f)} on {x.device}, the packed transformer "
                         f"takes {(packed.t, packed.f)} on {packed.weights.device}")
    if x.device.type == "cpu":
        return temporal_transformer_reference(x, packed)
    if x.device.type != "cuda" or f != WIDTH:
        raise ValueError(f"the CUDA kernel takes F={WIDTH} on a cuda device, got F={f} "
                         f"on {x.device}")
    out = torch.empty_like(x)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.temporal_transformer_forward(
            x.data_ptr(), packed.pe.data_ptr(), packed.weights.data_ptr(), out.data_ptr(),
            b, t, v, packed.n_layers, stream)
    if rc != 0:
        raise RuntimeError("temporal_transformer kernel launch failed: "
                           + lib.temporal_transformer_error_string(rc).decode())
    fused_temporal_transformer.launches += 1
    return out


fused_temporal_transformer.launches = 0


class FusedTemporalTransformer(nn.Module):
    """A ``TemporalTransformer`` that :func:`kernel_takes` in one launch of
    :func:`fused_temporal_transformer`, packed once, here, as a plain
    attribute (``.to()`` moves nothing the kernel reads)."""

    def __init__(self, transformer):
        super().__init__()
        self.packed = pack_temporal_transformer(transformer)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return fused_temporal_transformer(x, self.packed)
