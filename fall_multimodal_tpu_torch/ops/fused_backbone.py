"""Folded inference executor for a trained STGCAN backbone.

Counterpart of ``fall_multimodal_tpu/ops/pallas/fused_backbone.py``: folds
the data BN and every block of a port ``models.stgcan.STGCANBackbone`` once,
then runs data-BN affine -> each block through :func:`fused_stgcan_block`
-> mean over (T, V) -> optional ``cls`` head. Every block goes through the
block wrapper whatever its width, and there is no fallback: a tensor on the
card runs the CUDA kernel or raises. For a backbone on the card the
kernel's side of every block's constants is checked and packed here, once.
"""

from __future__ import annotations

import torch

from fall_multimodal_tpu_torch.ops.stgcan_block import (
    fold_block_params,
    fold_bn_module,
    fused_stgcan_block,
    packed_block,
)


class FusedBackbone:
    """Inference-only executor; ``backbone`` must be in eval mode semantics
    (its running statistics are what gets folded)."""

    @torch.no_grad()
    def __init__(self, backbone):
        self.data_bn = fold_bn_module(backbone.data_bn)
        self.blocks = []
        for i, block in enumerate(backbone.st_gcn_networks):
            folded, mode = fold_block_params(block, backbone.A * backbone.edge_importance[i])
            if folded.A.device.type == "cuda":
                packed_block(folded, mode, folded.A.device)
            self.blocks.append((folded, block.stride, mode))
        cls = backbone.cls
        self.cls = None if cls is None else (cls.weight[:, :, 0, 0].t().contiguous(),
                                             cls.bias)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n, t, v, c = x.shape
        s, b = self.data_bn
        y = (x.reshape(n, t, v * c) * s + b).reshape(n, t, v, c)
        for folded, stride, mode in self.blocks:
            y = fused_stgcan_block(y, folded, stride=stride, residual_mode=mode)
        y = y.mean(dim=(1, 2))
        if self.cls is not None:
            y = y @ self.cls[0] + self.cls[1]
        return y
