"""Fused eval-mode STGCAN block: folding, plain PyTorch version, CUDA wrapper.

Counterpart of ``fall_multimodal_tpu/ops/pallas/stgcan_block.py``. The
kernel (``csrc/stgcan_block.cu``) computes one block, graph conv -> BN ->
ReLU -> (9,1) temporal conv -> BN -> squeeze-excite gate -> residual ->
ReLU, on BN-folded constants. :func:`fused_stgcan_block` runs the plain
version :func:`stgcan_block_reference` for a tensor on the CPU and the CUDA
kernel for a tensor on the card; it has no other path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

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


_bound_lib = None


def _kernel():
    """The bound C entry point of ``csrc/stgcan_block.cu``."""
    global _bound_lib
    if _bound_lib is None:
        lib = build.load("stgcan_block")
        fn = lib.stgcan_block_forward
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.stgcan_block_error_string.argtypes = [ctypes.c_int]
        lib.stgcan_block_error_string.restype = ctypes.c_char_p
        _bound_lib = lib
    return _bound_lib


def _check(name: str, t: Optional[torch.Tensor], shape, device) -> None:
    if t is None:
        raise ValueError(f"folded.{name} is None but the residual mode needs it")
    if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(
            f"folded.{name} must be a contiguous, 16-byte aligned float32 tensor on "
            f"{device}, got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"folded.{name} has shape {tuple(t.shape)}, want {tuple(shape)}")


def fused_stgcan_block(x: torch.Tensor, folded: FoldedBlockParams, stride: int = 1,
                       residual_mode: str = "identity") -> torch.Tensor:
    """One fused eval STGCAN block, ``x (N, T, V, Cin) -> (N, T_out, V, C)``.

    A CPU tensor goes through :func:`stgcan_block_reference`; a CUDA tensor
    through the CUDA kernel, which is built at first use. Every launch adds
    one to ``fused_stgcan_block.launches``.
    """
    if residual_mode not in RESIDUAL_MODES:
        raise ValueError(f"residual_mode must be one of {sorted(RESIDUAL_MODES)}, "
                         f"got {residual_mode!r}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "x must be a contiguous float32 (N, T, V, Cin) tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})")
    n, t, v, cin = x.shape
    k = folded.A.shape[0]
    c = folded.bn1_scale.shape[0]
    h = c // 4
    if residual_mode == "identity" and (cin != c or stride != 1):
        raise ValueError(f"identity residual needs Cin == C and stride 1, got "
                         f"Cin={cin}, C={c}, stride={stride}")
    if x.device.type == "cpu":
        return stgcan_block_reference(x, folded, stride, residual_mode)
    if x.device.type != "cuda" or x.data_ptr() % 16:
        raise ValueError(f"fused_stgcan_block runs on cpu or cuda (16-byte aligned x), "
                         f"got {x.device}")
    if not (4 <= c <= 256 and c % 4 == 0 and k <= 4):
        raise ValueError(f"the CUDA kernel takes C <= 256, a multiple of 4, and at most "
                         f"4 graph partitions; got C={c}, K={k}")
    shapes = dict(A=(k, v, v), gcn_w=(cin, k * c), gcn_b=(k * c,), bn1_scale=(c,),
                  bn1_shift=(c,), tconv_w=(TAPS, c, c), tconv_b=(c,), bn2_scale=(c,),
                  bn2_shift=(c,), se_w1=(c, h), se_b1=(h,), se_w2=(h, c), se_b2=(c,))
    if residual_mode == "proj":
        shapes.update(res_w=(cin, c), res_scale=(c,), res_shift=(c,))
    for name, shape in shapes.items():
        _check(name, getattr(folded, name), shape, x.device)
    t_out = (t - 1) // stride + 1
    out = torch.empty((n, t_out, v, c), device=x.device, dtype=torch.float32)
    if n == 0:
        return out
    scratch = torch.empty((n, t, v, c), device=x.device, dtype=torch.float32)

    def ptr(name):
        tensor = getattr(folded, name) if name in shapes else None
        return None if tensor is None else tensor.data_ptr()

    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.stgcan_block_forward(
            x.data_ptr(), *(ptr(f) for f in FoldedBlockParams._fields),
            scratch.data_ptr(), out.data_ptr(),
            n, t, v, cin, k, c, stride, RESIDUAL_MODES[residual_mode], stream)
    if rc != 0:
        raise RuntimeError("stgcan_block kernel launch failed: "
                           + lib.stgcan_block_error_string(rc).decode())
    fused_stgcan_block.launches += 1
    return out


fused_stgcan_block.launches = 0
