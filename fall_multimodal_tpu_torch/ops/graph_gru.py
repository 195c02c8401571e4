"""One TARGCN graph-GRU layer over every frame in one kernel launch (K4):
packing, plain version, CUDA wrapper.

The kernel (``csrc/graph_gru.cu``) runs
:meth:`~fall_multimodal_tpu_torch.models.targcn.GraphGRUCell.scan` of a cell
with gated ``EmbGCN`` gate and update and hidden width 64, ``xs (B, T, V,
C) -> (B, T, V, 64)`` from h = 0, keeping each window's hidden state on the
SM from the first frame to the last: ``xs`` is read once and each frame's
state written once. It replaces no TPU kernel (the JAX package runs TARGCN
through XLA).

:func:`pack_graph_gru` lays out once what does not depend on the node
embeddings: the static branches' linears (in the kernel's fragment order,
:func:`fragments`), their biases, the column weights, and copies of the
pools. :func:`generate` makes, once a call, what does: the supports and the
node-wise weights and biases, in the same layout (stock ops, not cached
across calls). :func:`graph_gru_reference` computes the layer from those
packed and generated tensors in plain PyTorch. :func:`fused_graph_gru` runs
that for a CPU tensor and the CUDA kernel for a CUDA tensor; every launch
adds one to ``fused_graph_gru.launches``. The kernel multiplies in split
TF32 (float32 accuracy). :class:`FusedGraphGRU` is the module that serves a
cell this way, for a cell that :func:`kernel_takes`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.models.targcn import EmbGCN, GraphGRUCell, _supports
from fall_multimodal_tpu_torch.ops import build
from fall_multimodal_tpu_torch.utils.device import full_float32
from fall_multimodal_tpu_torch.utils.profiling import span

HIDDEN = 64          # kH of csrc/graph_gru.cu
MAX_NODES = 16       # kMaxV
MAX_DIM_IN = 64      # the widest input: x padded to 64 channels
WINDOWS = 16         # kWt: windows a CTA
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may take on an H100
GATE_TILES, UPDATE_TILES = 8, 4


def gate_rows(w: torch.Tensor) -> torch.Tensor:
    """The gate's 128 outputs (last axis; z, then r) in the kernel's row
    order: m16 tile i holds z of features 8i .. 8i+7, then r of the same
    features."""
    return w.unflatten(-1, (2, GATE_TILES, 8)).transpose(-3, -2).flatten(-3)


def gate_outputs(w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`gate_rows`: z, then r."""
    return w.unflatten(-1, (GATE_TILES, 2, 8)).transpose(-3, -2).flatten(-3)



def x_width(dim_in: int) -> int:
    """The input's channels as the kernel holds them: 8 or 64."""
    return 8 if dim_in <= 8 else MAX_DIM_IN


def smem_bytes(nodes: int, dim_in: int) -> int:
    """Shared memory of a CTA (``csrc/graph_gru.cu:smem_floats``): x, h and
    r*h of 16 windows and every node, the staged graph mixing, the update's
    partial sums, the supports and column weights."""
    kx = x_width(dim_in)
    return 4 * (nodes * WINDOWS * (kx + 4) + 2 * nodes * WINDOWS * (HIDDEN + 4)
                + 4 * WINDOWS * (kx + HIDDEN + 4) + UPDATE_TILES * 2 * 8 * 32
                + MAX_NODES * MAX_NODES + MAX_NODES)


def kernel_takes(cell) -> bool:
    """Whether the CUDA kernel takes this ``GraphGRUCell``: ``EmbGCN`` gate
    and update with the gated static branch, hidden width 64, at most 16
    nodes and 64 input channels, and the tiles of 16 windows within a CTA's
    shared memory (at 15 or 16 nodes, 8 input channels at most)."""
    gate, update = cell.gate, cell.update
    if not (isinstance(gate, EmbGCN) and isinstance(update, EmbGCN)
            and gate.linear is not None and update.linear is not None
            and cell.hidden_dim == HIDDEN):
        return False
    k_in, rows = gate.weights_pool.shape[1:]
    nodes, dim_in = gate.col_weight.shape[0], k_in - HIDDEN
    return (rows == 2 * HIDDEN and tuple(update.weights_pool.shape[1:]) == (k_in, HIDDEN)
            and 1 <= dim_in <= MAX_DIM_IN and nodes <= MAX_NODES
            and smem_bytes(nodes, dim_in) <= SMEM_LIMIT
            and torch.equal(gate.col_weight, update.col_weight))


def fragments(a: torch.Tensor) -> torch.Tensor:
    """``a (..., M, K)`` in ``mma.m16n8k8``'s A-fragment order, ``(..., M/16,
    K/8, 32, 4)``: per tile and k-step, lane ``4g + q`` holds ``a[g, q]``,
    ``a[g+8, q]``, ``a[g, q+4]``, ``a[g+8, q+4]``."""
    *lead, m, k = a.shape
    t = a.reshape(*lead, m // 16, 2, 8, k // 8, 2, 4)
    n = len(lead)
    return t.permute(*range(n), n, n + 3, n + 2, n + 5, n + 4, n + 1).reshape(
        *lead, m // 16, k // 8, 32, 4)


def unfragments(f: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`fragments`: ``(..., M/16, K/8, 32, 4) -> (..., M, K)``."""
    *lead, mt, ks, _, _ = f.shape
    t = f.reshape(*lead, mt, ks, 8, 4, 2, 2)
    n = len(lead)
    return t.permute(*range(n), n, n + 5, n + 2, n + 1, n + 4, n + 3).reshape(
        *lead, 16 * mt, 8 * ks)


def _pad_inputs(w: torch.Tensor, dim_in: int) -> torch.Tensor:
    """``w (..., dim_in + 64, O) -> (..., x_width + 64, O)``: zero rows for
    the input channels past ``dim_in``."""
    pad = w.new_zeros(*w.shape[:-2], x_width(dim_in) - dim_in, w.shape[-1])
    return torch.cat([w[..., :dim_in, :], pad, w[..., dim_in:, :]], dim=-2)


def _a_operand(w: torch.Tensor, dim_in: int, gate: bool) -> torch.Tensor:
    """``w (..., dim_in + 64, O)`` (inputs by outputs) as the kernel's A
    operand in fragment order: rows the outputs (the gate's reordered), K the
    padded inputs."""
    a = _pad_inputs(w, dim_in)
    if gate:
        a = gate_rows(a)
    return fragments(a.transpose(-1, -2).contiguous())


class PackedGraphGRU(NamedTuple):
    """What does not depend on the node embeddings, built once by
    :func:`pack_graph_gru`; the kernel reads the tensors through raw
    pointers, so they stay alive as long as this tuple."""

    gate_pool: torch.Tensor         # (D, dim_in + 64, 128) the gate's weights_pool
    gate_bias_pool: torch.Tensor    # (D, 128)
    update_pool: torch.Tensor       # (D, dim_in + 64, 64)
    update_bias_pool: torch.Tensor  # (D, 64)
    static_w: torch.Tensor          # fragments of the gate's, then the update's linear
    static_b: torch.Tensor          # (192,) their biases, the gate's reordered
    col: torch.Tensor               # (V,) column weights of the static branch
    nodes: int
    dim_in: int


class Generated(NamedTuple):
    """What the node embeddings give, made once a call by :func:`generate`."""

    supports: torch.Tensor   # (V, V) I + softmax(relu(E E^T))
    node_w: torch.Tensor     # (V, 12 tiles * k-steps * 128) node-wise fragments
    node_b: torch.Tensor     # (V, 192) node-wise biases, the gate's reordered


@torch.no_grad()
def pack_graph_gru(cell) -> PackedGraphGRU:
    """Pack a ``GraphGRUCell`` that :func:`kernel_takes` on the device its
    weights are on."""
    if not kernel_takes(cell):
        raise ValueError("the graph-GRU kernel takes gated EmbGCN gate and update of hidden "
                         f"width {HIDDEN}, at most {MAX_NODES} nodes and {MAX_DIM_IN} inputs")
    gate, update = cell.gate, cell.update
    dim_in = gate.weights_pool.shape[1] - HIDDEN
    static_w = torch.cat([
        _a_operand(gate.linear.weight.t(), dim_in, gate=True).reshape(-1),
        _a_operand(update.linear.weight.t(), dim_in, gate=False).reshape(-1)])
    static_b = torch.cat([gate_rows(gate.linear.bias), update.linear.bias])
    return PackedGraphGRU(
        gate.weights_pool.detach().clone(), gate.bias_pool.detach().clone(),
        update.weights_pool.detach().clone(), update.bias_pool.detach().clone(),
        static_w.contiguous(), static_b.contiguous(), gate.col_weight.clone().contiguous(),
        gate.col_weight.shape[0], dim_in)


@torch.no_grad()
def generate(packed: PackedGraphGRU, node_emb: torch.Tensor) -> Generated:
    """The supports and the node-wise weights and biases of ``node_emb (V,
    D)`` (``EmbGCN.prepare``), in the kernel's layout: a few stock ops, in
    full float32."""
    with full_float32():
        gate_w = torch.einsum("nd,dio->nio", node_emb, packed.gate_pool)
        update_w = torch.einsum("nd,dio->nio", node_emb, packed.update_pool)
        v = node_emb.shape[0]
        node_w = torch.cat([_a_operand(gate_w, packed.dim_in, gate=True).reshape(v, -1),
                            _a_operand(update_w, packed.dim_in, gate=False).reshape(v, -1)],
                           dim=1)
        node_b = torch.cat([gate_rows(node_emb @ packed.gate_bias_pool),
                            node_emb @ packed.update_bias_pool], dim=1)
        return Generated(_supports(node_emb).contiguous(), node_w, node_b.contiguous())


def _unpack(flat: torch.Tensor, dim_in: int):
    """(gate A ``(..., 128, K)``, update A ``(..., 64, K)``) of fragments laid
    out as the kernel reads them, ``flat (..., floats)``."""
    ks = (x_width(dim_in) + HIDDEN) // 8
    split = GATE_TILES * ks * 128
    lead = flat.shape[:-1]
    return (unfragments(flat[..., :split].reshape(*lead, GATE_TILES, ks, 32, 4)),
            unfragments(flat[..., split:].reshape(*lead, UPDATE_TILES, ks, 32, 4)))


def graph_gru_reference(xs: torch.Tensor, packed: PackedGraphGRU,
                        gen: Generated) -> torch.Tensor:
    """Plain PyTorch version of the kernel, from the packed and generated
    tensors: ``xs (B, T, V, C) -> (B, T, V, 64)`` from h = 0, the kernel's
    rows and padded inputs, each frame as :meth:`GraphGRUCell.step` computes
    it."""
    b, t, v, c = xs.shape
    gate_a, update_a = _unpack(gen.node_w, packed.dim_in)           # (V, rows, K)
    gate_l, update_l = _unpack(packed.static_w, packed.dim_in)      # (rows, K)
    gate_b, update_b = gen.node_b[:, :128], gen.node_b[:, 128:]
    gate_lb, update_lb = packed.static_b[:128], packed.static_b[128:]
    col = packed.col[None, :, None]
    x_pad = xs.new_zeros(b, t, v, x_width(c))
    x_pad[..., :c] = xs
    h = xs.new_zeros(b, v, HIDDEN)
    out = []
    for i in range(t):
        xh = torch.cat([x_pad[:, i], h], dim=-1)
        s = col * (xh @ gate_l.t()) + gate_lb
        pre = (torch.einsum("bnk,nok->bno", torch.einsum("nm,bmk->bnk", gen.supports, xh),
                            gate_a) + gate_b) + torch.sigmoid(s) * s
        z, r = gate_outputs(torch.sigmoid(pre)).chunk(2, dim=-1)
        xr = torch.cat([x_pad[:, i], r * h], dim=-1)
        s = col * (xr @ update_l.t()) + update_lb
        h_hat = torch.tanh((torch.einsum("bnk,nok->bno",
                                         torch.einsum("nm,bmk->bnk", gen.supports, xr),
                                         update_a) + update_b) + torch.sigmoid(s) * s)
        h = z * h + (1.0 - z) * h_hat
        out.append(h)
    return torch.stack(out, dim=1)


_bound_lib = None


def _kernel():
    """The bound C entry points of ``csrc/graph_gru.cu``."""
    global _bound_lib
    if _bound_lib is None:
        lib = build.load("graph_gru")
        fn = lib.graph_gru_forward
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("graph_gru_node_floats", "graph_gru_smem_bytes"):
            getattr(lib, name).restype = ctypes.c_int
        lib.graph_gru_node_floats.argtypes = [ctypes.c_int]
        lib.graph_gru_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.graph_gru_error_string.argtypes = [ctypes.c_int]
        lib.graph_gru_error_string.restype = ctypes.c_char_p
        for dim_in in (3, 64):
            kx = x_width(dim_in)
            if (lib.graph_gru_node_floats(kx) != (GATE_TILES + UPDATE_TILES) * (kx + HIDDEN) * 16
                    or lib.graph_gru_smem_bytes(14, kx) != smem_bytes(14, dim_in)):
                raise RuntimeError("csrc/graph_gru.cu and ops/graph_gru.py disagree on the "
                                   "packed layout or the shared memory")
        _bound_lib = lib
    return _bound_lib


def fused_graph_gru(xs: torch.Tensor, packed: PackedGraphGRU, gen: Generated) -> torch.Tensor:
    """The graph-GRU layer packed in ``packed``, with the node-wise weights
    ``gen`` (:func:`generate`), over ``xs (B, T, V, C)`` from h = 0: ``(B,
    T, V, 64)``.

    A CPU tensor goes through :func:`graph_gru_reference`; a CUDA tensor
    through the CUDA kernel, one launch whatever B > 0 (none at B = 0), built
    at first use.
    ``packed`` and ``gen`` must lie on ``xs``'s device. Every launch adds one
    to ``fused_graph_gru.launches``.
    """
    if xs.dim() != 4 or xs.dtype != torch.float32 or not xs.is_contiguous():
        raise ValueError(
            "xs must be a contiguous float32 (B, T, V, C) tensor, got "
            f"{xs.dtype} {tuple(xs.shape)} (contiguous={xs.is_contiguous()})")
    b, t, v, c = xs.shape
    if ((v, c) != (packed.nodes, packed.dim_in) or t < 1
            or not packed.col.device == gen.node_w.device == xs.device):
        raise ValueError(f"xs has (T, V, C) = {(t, v, c)} on {xs.device}, the packed layer "
                         f"takes T >= 1 and {(packed.nodes, packed.dim_in)} on "
                         f"{packed.col.device}, generated on {gen.node_w.device}")
    if xs.device.type == "cpu":
        return graph_gru_reference(xs, packed, gen)
    if xs.device.type != "cuda":
        raise ValueError(f"the graph-GRU kernel runs on a cuda device, got {xs.device}")
    out = torch.empty((b, t, v, HIDDEN), dtype=torch.float32, device=xs.device)
    if b == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.graph_gru_forward(
            xs.data_ptr(), gen.supports.data_ptr(), gen.node_w.data_ptr(),
            gen.node_b.data_ptr(), packed.static_w.data_ptr(), packed.static_b.data_ptr(),
            packed.col.data_ptr(), out.data_ptr(), b, t, v, c, x_width(c), stream)
    if rc != 0:
        raise RuntimeError("graph_gru kernel launch failed: "
                           + lib.graph_gru_error_string(rc).decode())
    fused_graph_gru.launches += 1
    return out


fused_graph_gru.launches = 0


class FusedGraphGRU(nn.Module):
    """A ``GraphGRUCell`` that :func:`kernel_takes`, whose :meth:`scan`
    generates the node-wise weights and runs one launch of
    :func:`fused_graph_gru`; packed once, here, as a plain attribute
    (``.to()`` moves nothing the kernel reads)."""

    def __init__(self, cell):
        super().__init__()
        self.packed = pack_graph_gru(cell)

    def scan(self, xs: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
        """``GraphGRUCell.scan``: the layer over every frame of ``xs (B, T,
        V, C)`` from h = 0, ``(B, T, V, 64)``; the same span and counter."""
        GraphGRUCell.steps += xs.shape[1]
        with span("targcn.recurrence"):
            return fused_graph_gru(xs, self.packed, generate(self.packed, node_emb))
