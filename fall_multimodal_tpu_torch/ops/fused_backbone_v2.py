"""Whole-backbone fused serving kernel: folding, plain version, CUDA wrapper.

Counterpart of ``fall_multimodal_tpu/ops/pallas/fused_backbone_v2.py``. The
kernel (``csrc/fused_backbone.cu``) runs an entire eval-mode STGCAN backbone
in one launch: data BN, every block, the mean over (T, V) and the ``cls``
head, ``x (N, T, V, Cin) -> logits (N, classes)``. It keeps the factored
graph convolution at the true channel widths; the TPU kernel's dense
adjacency fold and its padding to 128 lanes are not carried over, so the
folded constants here are the per-block ones of
:func:`~fall_multimodal_tpu_torch.ops.stgcan_block.fold_block_params`.
:func:`fused_backbone_forward` runs the plain version
:func:`fused_backbone_reference` for a tensor on the CPU and the CUDA kernel
for a tensor on the card; it has no other path. The kernel multiplies in
split TF32 (``ops/stgcan_block.py``); what it reads is built and checked once
per :class:`FoldedBackbone` by :func:`pack_backbone`, a call takes that
:class:`PackedBackbone` and checks ``x`` only, and :class:`WholeBackbone` is
the module that serves a headed backbone this way.
:func:`fused_backbone_emulated` repeats the kernel's arithmetic in plain
PyTorch, for tests.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.ops import build
from fall_multimodal_tpu_torch.ops.stgcan_block import (
    RESIDUAL_MODES,
    FoldedBlockParams,
    PackedBlock,
    check_constant,
    fold_block_params,
    fold_bn_module,
    pack_block,
    split_matmul,
    stgcan_block_emulated,
    stgcan_block_reference,
)

MAX_BLOCKS = 16   # kMaxBlocks of csrc/fused_backbone.cu


class FoldedBackbone(NamedTuple):
    """Inference-time constants of a whole backbone. The kernel reads the
    tensors through raw pointers: they stay alive as long as this tuple."""

    data_bn_scale: torch.Tensor              # (V*Cin,) data BN folded
    data_bn_shift: torch.Tensor              # (V*Cin,)
    blocks: Tuple[FoldedBlockParams, ...]
    stage_plan: Tuple[Tuple[int, str], ...]  # (stride, residual mode) per block
    cls_w: Optional[torch.Tensor]            # (C_last, classes); None without a head
    cls_b: Optional[torch.Tensor]            # (classes,)


@torch.no_grad()
def fold_backbone(backbone) -> FoldedBackbone:
    """Fold a port ``models.stgcan.STGCANBackbone`` (its running statistics
    are what gets folded) into kernel constants; ``cls_w`` and ``cls_b`` are
    None for a backbone without a ``cls`` head."""
    scale, shift = fold_bn_module(backbone.data_bn)
    blocks, plan = [], []
    for i, block in enumerate(backbone.st_gcn_networks):
        folded, mode = fold_block_params(block, backbone.A * backbone.edge_importance[i])
        blocks.append(folded)
        plan.append((block.stride, mode))
    cls = backbone.cls
    return FoldedBackbone(
        data_bn_scale=scale.contiguous(), data_bn_shift=shift.contiguous(),
        blocks=tuple(blocks), stage_plan=tuple(plan),
        cls_w=None if cls is None else cls.weight[:, :, 0, 0].t().contiguous(),
        cls_b=None if cls is None else cls.bias.contiguous())


def fused_backbone_reference(x: torch.Tensor, folded: FoldedBackbone) -> torch.Tensor:
    """Plain PyTorch version of the kernel on folded constants."""
    n, t, v, c = x.shape
    y = (x.reshape(n, t, v * c) * folded.data_bn_scale
         + folded.data_bn_shift).reshape(n, t, v, c)
    for block, (stride, mode) in zip(folded.blocks, folded.stage_plan):
        y = stgcan_block_reference(y, block, stride, mode)
    return y.mean(dim=(1, 2)) @ folded.cls_w + folded.cls_b


def fused_backbone_emulated(x: torch.Tensor, folded: FoldedBackbone,
                            matmul: Callable = split_matmul) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for tests: every block
    through :func:`~fall_multimodal_tpu_torch.ops.stgcan_block.
    stgcan_block_emulated` with ``matmul`` for its GEMMs."""
    n, t, v, c = x.shape
    y = (x.reshape(n, t, v * c) * folded.data_bn_scale
         + folded.data_bn_shift).reshape(n, t, v, c)
    for block, (stride, mode) in zip(folded.blocks, folded.stage_plan):
        y = stgcan_block_emulated(y, block, stride, mode, matmul)
    return y.mean(dim=(1, 2)) @ folded.cls_w + folded.cls_b


def check_plan(folded: FoldedBackbone) -> None:
    """Raise ``ValueError`` unless the stage plan fits the blocks."""
    if not folded.blocks or len(folded.blocks) != len(folded.stage_plan):
        raise ValueError(f"folded backbone has {len(folded.blocks)} blocks for a stage "
                         f"plan of {len(folded.stage_plan)}")
    cc = folded.blocks[0].gcn_w.shape[0]
    for i, (block, (stride, mode)) in enumerate(zip(folded.blocks, folded.stage_plan)):
        c = block.bn1_scale.shape[0]
        if mode not in RESIDUAL_MODES or stride not in (1, 2):
            raise ValueError(f"block {i}: stride must be 1 or 2 and the residual mode one "
                             f"of {sorted(RESIDUAL_MODES)}, got {stride}, {mode!r}")
        if mode == "identity" and (cc != c or stride != 1):
            raise ValueError(f"block {i}: identity residual needs Cin == C and stride 1, "
                             f"got Cin={cc}, C={c}, stride={stride}")
        cc = c


class PackedBackbone(NamedTuple):
    """What the kernel reads of a whole backbone, built once by
    :func:`pack_backbone`; keeps every tensor behind its pointers alive."""

    folded: FoldedBackbone
    blocks: Tuple[PackedBlock, ...]
    ptrs: ctypes.Array           # n_blocks * 14 device pointers
    ints: ctypes.Array           # n_blocks * (C, stride, residual mode, adjacency nonzeros)
    v: int
    cin: int
    k: int
    classes: int

    def scratch_floats(self, t: int) -> Tuple[int, int]:
        """Per-sample floats of an activation buffer and of the graph-conv
        scratch for ``t`` input frames, each a multiple of 4."""
        act = g = 0
        for block, (stride, _) in zip(self.blocks, self.folded.stage_plan):
            g = max(g, t * self.v * block.c)
            t = (t - 1) // stride + 1
            act = max(act, t * self.v * block.c)
        return (act + 3) & ~3, (g + 3) & ~3


@torch.no_grad()
def pack_backbone(folded: FoldedBackbone, device) -> PackedBackbone:
    """Check the plan and every constant of ``folded`` against what the
    kernel reads on ``device`` and build the kernel's side of them. Raises
    ``ValueError`` for what the kernel does not take; the kernel's size
    limits hold only for a card ``device``."""
    if folded.cls_w is None:
        raise ValueError(
            "pack_backbone needs a backbone with a cls head (num_classes set); "
            "a headless stream runs through ops.fused_backbone.FusedBackbone")
    check_plan(folded)
    device = torch.device(device)
    k, v = folded.blocks[0].A.shape[:2]
    cin = folded.blocks[0].gcn_w.shape[0]
    if device.type == "cuda" and (len(folded.blocks) > MAX_BLOCKS or k > 4):
        raise ValueError(f"the CUDA kernel takes at most {MAX_BLOCKS} blocks and 4 graph "
                         f"partitions; got {len(folded.blocks)} blocks, K={k}")
    blocks, ptrs, ints = [], [], []
    cc = cin
    for i, (block, (stride, mode)) in enumerate(zip(folded.blocks, folded.stage_plan)):
        if block.gcn_w.shape[0] != cc or block.A.shape[:2] != (k, v):
            raise ValueError(f"blocks[{i}] takes Cin={block.gcn_w.shape[0]} and an adjacency "
                             f"{tuple(block.A.shape)}, the plan hands it Cin={cc}, {(k, v, v)}")
        packed = pack_block(block, mode, device, name=f"blocks[{i}]")
        blocks.append(packed)
        ptrs += list(packed.ptrs)
        ints += [packed.c, stride, RESIDUAL_MODES[mode], packed.nnz]
        cc = packed.c
    classes = folded.cls_b.shape[0]
    head = dict(data_bn_scale=(v * cin,), data_bn_shift=(v * cin,), cls_w=(cc, classes),
                cls_b=(classes,))
    for name, shape in head.items():
        check_constant(name, getattr(folded, name), shape, device)
    return PackedBackbone(folded, tuple(blocks), (ctypes.c_void_p * len(ptrs))(*ptrs),
                          (ctypes.c_int * len(ints))(*ints), v, cin, k, classes)


_bound_lib = None


def _kernel():
    """The bound C entry point of ``csrc/fused_backbone.cu``."""
    global _bound_lib
    if _bound_lib is None:
        lib = build.load("fused_backbone")
        fn = lib.fused_backbone_forward
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_backbone_error_string.argtypes = [ctypes.c_int]
        lib.fused_backbone_error_string.restype = ctypes.c_char_p
        _bound_lib = lib
    return _bound_lib


def fused_backbone_forward(x: torch.Tensor, packed: PackedBackbone) -> torch.Tensor:
    """The whole backbone, ``x (N, T, V, Cin) -> logits (N, classes)``, on the
    constants :func:`pack_backbone` made (and checked) once.

    A CPU tensor goes through :func:`fused_backbone_reference` on
    ``packed.folded``; a CUDA tensor on the pack's device through the CUDA
    kernel, one launch whatever the stage plan and N, built at first use.
    Every launch adds one to ``fused_backbone_forward.launches``.
    """
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "x must be a contiguous float32 (N, T, V, Cin) tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})")
    n, t, v, cin = x.shape
    folded = packed.folded
    if x.device.type == "cpu":
        return fused_backbone_reference(x, folded)
    if x.device != folded.data_bn_scale.device or x.data_ptr() % 16:
        raise ValueError(f"fused_backbone_forward runs on cpu or on the pack's device "
                         f"{folded.data_bn_scale.device} (16-byte aligned x), got {x.device}")
    if (v, cin) != (packed.v, packed.cin):
        raise ValueError(f"x has (V, Cin) = {(v, cin)}, the packed backbone takes "
                         f"{(packed.v, packed.cin)}")
    logits = torch.empty((n, packed.classes), device=x.device, dtype=torch.float32)
    if n == 0:
        return logits
    act_stride, g_stride = packed.scratch_floats(t)
    act = torch.empty((2, n, act_stride), device=x.device, dtype=torch.float32)
    scratch = torch.empty((n, g_stride), device=x.device, dtype=torch.float32)

    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_backbone_forward(
            x.data_ptr(), folded.data_bn_scale.data_ptr(), folded.data_bn_shift.data_ptr(),
            packed.ptrs, packed.ints, folded.cls_w.data_ptr(), folded.cls_b.data_ptr(),
            act[0].data_ptr(), act[1].data_ptr(), scratch.data_ptr(), logits.data_ptr(),
            n, t, v, cin, packed.k, len(packed.blocks), packed.classes, act_stride, g_stride,
            stream)
    if rc != 0:
        raise RuntimeError("fused_backbone kernel launch failed: "
                           + lib.fused_backbone_error_string(rc).decode())
    fused_backbone_forward.launches += 1
    return logits


fused_backbone_forward.launches = 0


class WholeBackbone(nn.Module):
    """A headed ``STGCANBackbone`` (its running statistics are folded) in one
    launch of :func:`fused_backbone_forward`, folded and packed once, here.
    The forward takes the classifier's contract and ignores ``sensor`` and
    ``generator``; the pack is a plain attribute, so ``.to()`` moves nothing
    a pointer table reads."""

    def __init__(self, backbone):
        super().__init__()
        folded = fold_backbone(backbone)
        self.packed = pack_backbone(folded, folded.data_bn_scale.device)

    def forward(self, skeleton: torch.Tensor, sensor: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return fused_backbone_forward(skeleton, self.packed)
