"""Folded inference module for a trained STGCAN backbone, a K1 launch a block.

Counterpart of ``fall_multimodal_tpu/ops/pallas/fused_backbone.py``: folds
the data BN and every block of a port ``models.stgcan.STGCANBackbone`` once
(:func:`~fall_multimodal_tpu_torch.ops.fused_backbone_v2.fold_backbone`),
packs every block once (:func:`pack_block`), then runs data-BN affine -> each
block through :func:`fused_stgcan_block` -> mean over (T, V) -> optional
``cls`` head. Every block goes through the block wrapper whatever its width,
and there is no fallback: a tensor on the card runs the CUDA kernel or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import fold_backbone
from fall_multimodal_tpu_torch.ops.stgcan_block import fused_stgcan_block, pack_block


class FusedBackbone(nn.Module):
    """Inference-only module; ``backbone``'s running statistics are what gets
    folded. The fold and the packs are plain attributes, so ``.to()`` moves
    nothing a pointer table reads."""

    def __init__(self, backbone):
        super().__init__()
        self.folded = fold_backbone(backbone)
        device = self.folded.data_bn_scale.device
        self.blocks = tuple(pack_block(block, mode, device, name=f"blocks[{i}]")
                            for i, (block, (_, mode)) in enumerate(
                                zip(self.folded.blocks, self.folded.stage_plan)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        folded = self.folded
        n, t, v, c = x.shape
        y = (x.contiguous().reshape(n, t, v * c) * folded.data_bn_scale
             + folded.data_bn_shift).reshape(n, t, v, c)
        for packed, (stride, _) in zip(self.blocks, folded.stage_plan):
            y = fused_stgcan_block(y, packed, stride)
        y = y.mean(dim=(1, 2))
        if folded.cls_w is not None:
            y = y @ folded.cls_w + folded.cls_b
        return y
