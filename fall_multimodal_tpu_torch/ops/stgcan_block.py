"""Fused eval-mode STGCAN block: folding, plain PyTorch version, CUDA wrapper.

Counterpart of ``fall_multimodal_tpu/ops/pallas/stgcan_block.py``. The
kernel (``csrc/stgcan_block.cu``) computes one block, graph conv -> BN ->
ReLU -> (9,1) temporal conv -> BN -> squeeze-excite gate -> residual ->
ReLU, on BN-folded constants. :func:`fused_stgcan_block` runs the plain
version :func:`stgcan_block_reference` for a tensor on the CPU and the CUDA
kernel for a tensor on the card; it has no other path.

The kernel multiplies on tensor cores in split TF32: every float32 operand
is ``hi + lo`` with both halves in TF32, and a product is
``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` summed in float32, which keeps float32
accuracy. What the kernel reads (the weights' halves in the order of its
``wgmma`` operand, two folded shift tables, a table of pointers) is built
once per :class:`FoldedBlockParams` by :func:`pack_block`, which is also where
every constant is checked, and a call takes that :class:`PackedBlock` and
checks ``x`` only.
:func:`stgcan_block_emulated` repeats the kernel's arithmetic in plain
PyTorch (for tests: it bounds the numerics where there is no card).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from fall_multimodal_tpu_torch.ops import build

RESIDUAL_MODES = {"none": 0, "identity": 1, "proj": 2}
TAPS, PAD = 9, 4


class FoldedBlockParams(NamedTuple):
    """Inference-time constants of one STGCAN block, BN pre-folded; the same
    fields and layouts as the JAX package's ``FoldedBlockParams``."""

    A: torch.Tensor            # (K, V, V) adjacency * edge importance
    gcn_w: torch.Tensor        # (Cin, K*C)
    gcn_b: torch.Tensor        # (K*C,)
    bn1_scale: torch.Tensor    # (C,)   tcn.0 folded
    bn1_shift: torch.Tensor
    tconv_w: torch.Tensor      # (9, C, C)  (tap, in, out)
    tconv_b: torch.Tensor      # (C,)
    bn2_scale: torch.Tensor    # (C,)   tcn.3 folded
    bn2_shift: torch.Tensor
    se_w1: torch.Tensor        # (C, C//4) with the SE BN folded in
    se_b1: torch.Tensor        # (C//4,)
    se_w2: torch.Tensor        # (C//4, C)
    se_b2: torch.Tensor        # (C,)
    res_w: Optional[torch.Tensor]      # (Cin, C), "proj" only
    res_scale: Optional[torch.Tensor]  # (C,) residual BN folded
    res_shift: Optional[torch.Tensor]  # (C,) includes the projection's bias


def fold_bn(scale, bias, mean, var, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm at inference == per-channel affine ``y = x*s + t``."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def fold_bn_module(bn: torch.nn.BatchNorm1d) -> Tuple[torch.Tensor, torch.Tensor]:
    return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


@torch.no_grad()
def fold_block_params(block, A: torch.Tensor) -> Tuple[FoldedBlockParams, str]:
    """Fold a port ``models.stgcan.STGCANBlock`` into kernel constants.

    ``A`` is the block's adjacency times its edge importance. Returns the
    folded constants and the block's residual mode (none/identity/proj).
    """
    bn1_s, bn1_t = fold_bn_module(block.tcn[0])
    bn2_s, bn2_t = fold_bn_module(block.tcn[3])
    att = block.channel_attention_module.atten
    se_s, se_t = fold_bn_module(att[2])
    # BN(x W1 + b1) = x (W1 * s) + (b1 * s + t)
    se_w1 = att[1].weight[:, :, 0, 0].t() * se_s[None, :]
    se_b1 = att[1].bias * se_s + se_t
    conv = block.tcn[2]
    res_w = res_s = res_t = None
    if block.residual_mode == "proj":
        proj, rbn = block.residual
        rs, rt = fold_bn_module(rbn)
        res_w = proj.weight[:, :, 0, 0].t().contiguous()
        res_s, res_t = rs, proj.bias * rs + rt
    folded = FoldedBlockParams(
        A=A.contiguous(),
        gcn_w=block.gcn.conv.weight[:, :, 0, 0].t().contiguous(),
        gcn_b=block.gcn.conv.bias.contiguous(),
        bn1_scale=bn1_s, bn1_shift=bn1_t,
        tconv_w=conv.weight[:, :, :, 0].permute(2, 1, 0).contiguous(),
        tconv_b=conv.bias.contiguous(),
        bn2_scale=bn2_s, bn2_shift=bn2_t,
        se_w1=se_w1.contiguous(), se_b1=se_b1.contiguous(),
        se_w2=att[4].weight[:, :, 0, 0].t().contiguous(),
        se_b2=att[4].bias.contiguous(),
        res_w=res_w, res_scale=res_s, res_shift=res_t,
    )
    return folded, block.residual_mode


def stgcan_block_reference(x: torch.Tensor, p: FoldedBlockParams, stride: int = 1,
                           residual_mode: str = "identity") -> torch.Tensor:
    """Plain PyTorch version of the kernel on folded constants (the
    counterpart of ``fused_backbone.py:_xla_block``)."""
    n, t, v, cin = x.shape
    k = p.A.shape[0]
    c = p.bn1_scale.shape[0]
    y = (x.reshape(-1, cin) @ p.gcn_w + p.gcn_b).reshape(n, t, v, k, c)
    y = torch.einsum("ntvkc,kvw->ntwc", y, p.A)
    y = torch.relu(y * p.bn1_scale + p.bn1_shift)
    t_out = (t - 1) // stride + 1
    yp = torch.nn.functional.pad(y, (0, 0, 0, 0, PAD, PAD))
    acc = sum(
        yp[:, tap: tap + (t_out - 1) * stride + 1: stride].reshape(-1, c) @ p.tconv_w[tap]
        for tap in range(TAPS)
    ).reshape(n, t_out, v, c) + p.tconv_b
    acc = acc * p.bn2_scale + p.bn2_shift
    m = acc.mean(dim=(1, 2))
    a = torch.relu(m @ p.se_w1 + p.se_b1)
    a = torch.sigmoid(a @ p.se_w2 + p.se_b2)
    acc = acc * a[:, None, None, :]
    if residual_mode == "identity":
        acc = acc + x[:, ::stride]
    elif residual_mode == "proj":
        r = (x[:, ::stride].reshape(-1, cin) @ p.res_w).reshape(n, t_out, v, c)
        acc = acc + (r * p.res_scale + p.res_shift)
    return torch.relu(acc)


# ------------------------------------------------ split TF32, packed constants

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: integer arithmetic on the bit pattern.
    The 13 low mantissa bits of the result are zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(t)``, ``lo = tf32(t - hi)``; ``hi + lo``
    equals ``t`` to 2**-21 relative."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel computes it: three TF32 products summed in
    float32, small terms first; the ``lo*lo`` term is dropped."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def single_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands rounded to TF32 once: what a plain TF32
    tensor-core product gives (about three decimal digits)."""
    return tf32_round(a) @ tf32_round(b)


def _round8(n: int) -> int:
    return (n + 7) & ~7


COL_BLOCK = 64   # kPassCols of csrc/stgcan_phases.cuh: columns a CTA multiplies at once


def pack_gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """A GEMM weight ``(k, c)`` as the kernel's B operand: rows padded with
    zeros to a multiple of 8 and columns to a multiple of 64, split into TF32
    halves, and laid out as ``[c // 64, k // 8, piece, c % 64, k % 4]`` with
    ``piece = 2 * (0 hi | 1 lo) + k % 8 // 4``. A run of 8 columns of one
    piece is a "core matrix" of ``wgmma``'s K-major shared-memory operand
    (8 rows of 16 bytes), and the 8-row blocks of one column block are
    contiguous, so a chunk of k reaches shared memory in one bulk copy."""
    k, c = w.shape
    kp, cp = _round8(k), -(-c // COL_BLOCK) * COL_BLOCK
    hi, lo = split_tf32(torch.nn.functional.pad(w, (0, cp - c, 0, kp - k)))
    shape = (kp // 8, 2, 4, cp // COL_BLOCK, COL_BLOCK)
    halves = torch.stack([hi.view(shape), lo.view(shape)], dim=1)
    # (k // 8, half, k%8 // 4, k % 4, c // 64, c % 64) -> (c // 64, k // 8, half, k%8 // 4, c % 64, k % 4)
    return halves.permute(4, 0, 1, 2, 5, 3).reshape(
        cp // COL_BLOCK, kp // 8, 4, COL_BLOCK, 4).contiguous()


def unpack_gemm_weight(packed: torch.Tensor, k: int, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(hi, lo)`` halves, each ``(k, c)``, of a :func:`pack_gemm_weight`."""
    cb, kb = packed.shape[:2]
    halves = packed.view(cb, kb, 2, 2, COL_BLOCK, 4).permute(2, 1, 3, 5, 0, 4)
    halves = halves.reshape(2, kb * 8, cb * COL_BLOCK)
    return halves[0, :k, :c], halves[1, :k, :c]


def pack_adjacency(A: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The nonzeros of ``A (K, V, V)`` as the kernel walks them, and their
    count: an int32 vector of ``K*V + 1`` offsets by ``(k, w)``, then the
    joints ``v`` with ``A[k, v, w] != 0`` in that order, then the weights
    (float bits). A skeleton's partitioned adjacency is sparse (40 of 588
    entries for the 14-joint graph), and so is its product with a learned edge
    importance."""
    at = A.permute(0, 2, 1)                                   # (k, w, v)
    mask = at != 0
    offsets = torch.nn.functional.pad(mask.sum(-1).flatten().cumsum(0), (1, 0))
    joints = mask.nonzero()[:, 2]                             # row-major: by (k, w), then v
    packed = torch.cat([offsets.to(torch.int32), joints.to(torch.int32),
                        at[mask].contiguous().view(torch.int32)])
    return packed, int(joints.numel())


def unpack_adjacency(packed: torch.Tensor, k: int, v: int) -> torch.Tensor:
    """The dense ``(K, V, V)`` adjacency of a :func:`pack_adjacency`."""
    nnz = (packed.numel() - k * v - 1) // 2
    offsets, joints = packed[:k * v + 1].long(), packed[k * v + 1: k * v + 1 + nnz].long()
    weights = packed[k * v + 1 + nnz:].view(torch.float32)
    kw = torch.repeat_interleave(torch.arange(k * v, device=packed.device),
                                 offsets[1:] - offsets[:-1])
    at = torch.zeros((k * v, v), dtype=torch.float32, device=packed.device)
    at[kw, joints] = weights
    return at.view(k, v, v).permute(0, 2, 1).contiguous()


class PackedBlock(NamedTuple):
    """What the kernel reads of one block, built once by :func:`pack_block`.
    It keeps ``folded`` (whose small tensors the kernel reads as they are,
    and which the plain version runs on) and the derived tensors alive;
    ``ptrs`` is the kernel's pointer table."""

    folded: FoldedBlockParams
    residual_mode: str
    nbr: torch.Tensor              # int32, the adjacency's nonzeros (pack_adjacency)
    nnz: int
    gcn_w: torch.Tensor            # packed, k-row = k * round8(Cin) + i
    g_shift: torch.Tensor          # (V, C) BN1 of the graph conv's bias, per joint
    tconv_w: torch.Tensor          # packed, k-row = tap * round8(C) + c_in
    y_shift: torch.Tensor          # (C,) BN2 of the temporal conv's bias
    res_w: Optional[torch.Tensor]  # packed, k-row = i
    ptrs: ctypes.Array             # 14 device pointers, NULL for an unused field
    v: int
    cin: int
    k: int
    c: int


def graph_conv_shift(folded: FoldedBlockParams) -> torch.Tensor:
    """``(V, C)``: BN1 applied to the graph conv's bias as joint w sees it,
    ``sum_k (sum_v A[k, v, w]) * b_k``. Written without a matmul, so that it
    is float32 whatever the process's TF32 switches say."""
    k, c = folded.A.shape[0], folded.bn1_scale.shape[0]
    colsum = folded.A.sum(dim=1)                                     # (K, V): sum_v A[k,v,w]
    bias = (colsum[:, :, None] * folded.gcn_b.view(k, 1, c)).sum(dim=0)
    return (bias * folded.bn1_scale + folded.bn1_shift).contiguous()


def gemm_rows(folded: FoldedBlockParams) -> Tuple[torch.Tensor, torch.Tensor,
                                                  Optional[torch.Tensor]]:
    """The three GEMM weights with their k-rows in the kernel's order, the
    input-channel dimension padded with zero rows to a multiple of 8: the
    channel mix ``(K * Cin8, C)`` (row ``k * Cin8 + i``, applied after the
    adjacency is contracted on x), the taps ``(9 * C8, C)``, the residual
    projection ``(Cin8, C)`` or None."""
    cin = folded.gcn_w.shape[0]
    c = folded.bn1_scale.shape[0]
    k = folded.A.shape[0]
    pad_in = torch.nn.functional.pad
    mix = pad_in(folded.gcn_w.view(cin, k, c).permute(1, 0, 2), (0, 0, 0, _round8(cin) - cin))
    taps = pad_in(folded.tconv_w, (0, 0, 0, _round8(c) - c))
    res = None if folded.res_w is None else pad_in(folded.res_w, (0, 0, 0, _round8(cin) - cin))
    return mix.reshape(-1, c), taps.reshape(-1, c), res


@torch.no_grad()
def pack_block(folded: FoldedBlockParams, residual_mode: str, device,
               name: str = "folded") -> PackedBlock:
    """Check every constant of ``folded`` against what the kernel reads
    through raw pointers on ``device`` and build the kernel's side of them.
    Raises ``ValueError`` for what the kernel does not take; the kernel's
    size limits hold only for a card ``device`` (the CPU runs the plain
    version at any width)."""
    if residual_mode not in RESIDUAL_MODES:
        raise ValueError(f"residual_mode must be one of {sorted(RESIDUAL_MODES)}, "
                         f"got {residual_mode!r}")
    device = torch.device(device)
    k, v = folded.A.shape[0], folded.A.shape[1]
    cin = folded.gcn_w.shape[0]
    c = folded.bn1_scale.shape[0]
    if device.type == "cuda" and not (4 <= c <= 256 and c % 4 == 0 and k <= 4):
        raise ValueError(f"{name}: the CUDA kernel takes C <= 256, a multiple of 4, and at "
                         f"most 4 graph partitions; got C={c}, K={k}")
    shapes = block_constant_shapes(v, cin, k, c, residual_mode)
    for field, shape in shapes.items():
        check_constant(f"{name}.{field}", getattr(folded, field), shape, device)
    mix, taps, res = gemm_rows(folded)
    g_shift = graph_conv_shift(folded)
    y_shift = (folded.tconv_b * folded.bn2_scale + folded.bn2_shift).contiguous()
    proj = residual_mode == "proj"
    nbr, nnz = pack_adjacency(folded.A)
    packed = dict(nbr=nbr, nnz=nnz, gcn_w=pack_gemm_weight(mix), g_shift=g_shift,
                  tconv_w=pack_gemm_weight(taps), y_shift=y_shift,
                  res_w=pack_gemm_weight(res) if proj else None)
    order = (nbr, packed["gcn_w"], g_shift, folded.bn1_scale, packed["tconv_w"],
             folded.bn2_scale, y_shift, folded.se_w1, folded.se_b1, folded.se_w2,
             folded.se_b2, packed["res_w"], folded.res_scale if proj else None,
             folded.res_shift if proj else None)
    ptrs = [None if t is None else t.data_ptr() for t in order]
    return PackedBlock(folded=folded, residual_mode=residual_mode, **packed,
                       ptrs=(ctypes.c_void_p * len(ptrs))(*ptrs), v=v, cin=cin, k=k, c=c)


def unpack_block(packed: PackedBlock) -> FoldedBlockParams:
    """The :class:`FoldedBlockParams` a :class:`PackedBlock` was made from,
    with the three GEMM weights rebuilt from their TF32 halves (``hi + lo``,
    equal to the originals to 2**-21 relative) and the adjacency from its
    nonzeros (exact); every other field is the original tensor."""
    f, cin, k, c = packed.folded, packed.cin, packed.k, packed.c
    mix = sum(unpack_gemm_weight(packed.gcn_w, k * _round8(cin), c))
    taps = sum(unpack_gemm_weight(packed.tconv_w, TAPS * _round8(c), c))
    res = None
    if packed.res_w is not None:
        res = sum(unpack_gemm_weight(packed.res_w, cin, c)).contiguous()
    return f._replace(
        A=unpack_adjacency(packed.nbr, k, packed.v),
        gcn_w=mix.view(k, _round8(cin), c)[:, :cin].permute(1, 0, 2).reshape(cin, k * c),
        tconv_w=taps.view(TAPS, _round8(c), c)[:, :c].contiguous(), res_w=res)


def stgcan_block_emulated(x: torch.Tensor, p: FoldedBlockParams, stride: int = 1,
                          residual_mode: str = "identity",
                          matmul: Callable = split_matmul) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for tests: the adjacency is
    contracted on ``x`` first, the three GEMMs go through ``matmul``
    (:func:`split_matmul`, or :func:`single_tf32_matmul` to see what one TF32
    product would give) on the rows :func:`gemm_rows` hands the kernel, and
    the biases are folded into the BN shifts as :func:`pack_block` does."""
    n, t, v, cin = x.shape
    k = p.A.shape[0]
    c = p.bn1_scale.shape[0]
    cin8, c8 = _round8(cin), _round8(c)
    mix, taps, res = gemm_rows(p)
    z = torch.einsum("ntvi,kvw->ntwki", x, p.A)
    z = torch.nn.functional.pad(z, (0, cin8 - cin)).reshape(-1, k * cin8)
    g = torch.relu(matmul(z, mix).reshape(n, t, v, c) * p.bn1_scale + graph_conv_shift(p))
    t_out = (t - 1) // stride + 1
    gp = torch.nn.functional.pad(g, (0, c8 - c, 0, 0, PAD, PAD))
    rows = torch.cat([gp[:, tap: tap + (t_out - 1) * stride + 1: stride]
                      for tap in range(TAPS)], dim=-1).reshape(-1, TAPS * c8)
    y = matmul(rows, taps).reshape(n, t_out, v, c) * p.bn2_scale \
        + (p.tconv_b * p.bn2_scale + p.bn2_shift)
    a = torch.relu(y.mean(dim=(1, 2)) @ p.se_w1 + p.se_b1)
    a = torch.sigmoid(a @ p.se_w2 + p.se_b2)
    y = y * a[:, None, None, :]
    if residual_mode == "identity":
        y = y + x[:, ::stride]
    elif residual_mode == "proj":
        xr = torch.nn.functional.pad(x[:, ::stride], (0, cin8 - cin)).reshape(-1, cin8)
        y = y + (matmul(xr, res).reshape(n, t_out, v, c) * p.res_scale + p.res_shift)
    return torch.relu(y)


# ------------------------------------------------------------------ the wrapper

_bound_lib = None


def _kernel():
    """The bound C entry point of ``csrc/stgcan_block.cu``."""
    global _bound_lib
    if _bound_lib is None:
        lib = build.load("stgcan_block")
        fn = lib.stgcan_block_forward
        fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.stgcan_block_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.stgcan_block_smem_bytes.restype = ctypes.c_size_t
        lib.stgcan_block_error_string.argtypes = [ctypes.c_int]
        lib.stgcan_block_error_string.restype = ctypes.c_char_p
        _bound_lib = lib
    return _bound_lib


def kernel_smem_bytes(t: int, v: int, k: int, c: int, stride: int) -> int:
    """Dynamic shared memory, in bytes, of one CTA of the block kernel at
    these sizes, at most (with one CTA a sample; asks the built library;
    needs ``nvcc``)."""
    return int(_kernel().stgcan_block_smem_bytes(t, v, k, c, stride))


def block_constant_shapes(v: int, cin: int, k: int, c: int, residual_mode: str) -> dict:
    """``{field: shape}`` of the constants a block with this residual mode
    hands to a kernel (the ``res_*`` fields only for ``"proj"``)."""
    h = c // 4
    shapes = dict(A=(k, v, v), gcn_w=(cin, k * c), gcn_b=(k * c,), bn1_scale=(c,),
                  bn1_shift=(c,), tconv_w=(TAPS, c, c), tconv_b=(c,), bn2_scale=(c,),
                  bn2_shift=(c,), se_w1=(c, h), se_b1=(h,), se_w2=(h, c), se_b2=(c,))
    if residual_mode == "proj":
        shapes.update(res_w=(cin, c), res_scale=(c,), res_shift=(c,))
    return shapes


def check_constant(name: str, t: Optional[torch.Tensor], shape, device) -> None:
    """Raise unless ``t`` is what a kernel reads through a raw pointer."""
    if t is None:
        raise ValueError(f"{name} is None but the residual mode needs it")
    if (t.device.type != device.type or t.dtype != torch.float32 or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name} must be a contiguous, 16-byte aligned float32 tensor on "
            f"{device}, got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")


def fused_stgcan_block(x: torch.Tensor, packed: PackedBlock, stride: int = 1) -> torch.Tensor:
    """One fused eval STGCAN block, ``x (N, T, V, Cin) -> (N, T_out, V, C)``,
    on the constants :func:`pack_block` made (and checked) once.

    A CPU tensor goes through :func:`stgcan_block_reference` on
    ``packed.folded``; a CUDA tensor on the packed block's device through the
    CUDA kernel, which is built at first use. Every launch adds one to
    ``fused_stgcan_block.launches``.
    """
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "x must be a contiguous float32 (N, T, V, Cin) tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})")
    n, t, v, cin = x.shape
    c, mode = packed.c, packed.residual_mode
    if mode == "identity" and (cin != c or stride != 1):
        raise ValueError(f"identity residual needs Cin == C and stride 1, got "
                         f"Cin={cin}, C={c}, stride={stride}")
    if x.device.type == "cpu":
        return stgcan_block_reference(x, packed.folded, stride, mode)
    if x.device != packed.nbr.device or x.data_ptr() % 16:
        raise ValueError(f"fused_stgcan_block runs on cpu or on the packed block's device "
                         f"{packed.nbr.device} (16-byte aligned x), got {x.device}")
    if (v, cin) != (packed.v, packed.cin):
        raise ValueError(f"x has (V, Cin) = {(v, cin)}, the packed block takes "
                         f"{(packed.v, packed.cin)}")
    t_out = (t - 1) // stride + 1
    out = torch.empty((n, t_out, v, c), device=x.device, dtype=torch.float32)
    if n == 0:
        return out
    scratch = torch.empty((n, t, v, c), device=x.device, dtype=torch.float32)

    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.stgcan_block_forward(
            x.data_ptr(), packed.ptrs, scratch.data_ptr(), out.data_ptr(),
            n, t, v, cin, packed.k, c, stride, RESIDUAL_MODES[mode], packed.nnz, stream)
    if rc != 0:
        raise RuntimeError("stgcan_block kernel launch failed: "
                           + lib.stgcan_block_error_string(rc).decode())
    fused_stgcan_block.launches += 1
    return out


fused_stgcan_block.launches = 0
