"""Losses with the reference's quirky semantics as explicit switches
(counterpart of the JAX package's ``train/losses.py:18-52`` and
``train/loop.py:266-274``).

The reference trains with ``torch.nn.CrossEntropyLoss`` on *soft* targets
(score-weighted smoothed labels from data prep, ``har_create4.py:114-123``),
and the notebook-canonical GSTCAN additionally applies ``F.softmax`` in the
model forward *before* that loss (``GSTCAN_UR_conv.ipynb:1``) — i.e. the loss
it actually minimizes is CE(softmax(logits), soft_target). Both behaviours
are reproducible here; ``softmax_before_ce`` corresponds to the model-config
flag ``softmax_output``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def one_hot_if_needed(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    if target.dim() == 1:
        return F.one_hot(target.long(), num_classes).float()
    return target.float()


def smooth_labels(target: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Uniform label smoothing: (1-eps) * y + eps / C."""
    if smoothing <= 0.0:
        return target
    num_classes = target.shape[-1]
    return target * (1.0 - smoothing) + smoothing / num_classes


def cross_entropy_per_sample(
    logits: torch.Tensor,
    target: torch.Tensor,
    label_smoothing: float = 0.0,
    softmax_before_ce: bool = False,
) -> torch.Tensor:
    """Soft-target cross entropy per row, ``(N,)``. With
    ``softmax_before_ce`` the logits first go through a softmax and the
    (second) log-softmax is applied to the probabilities, as
    CrossEntropyLoss on softmax outputs computes it in the reference
    notebooks."""
    target = one_hot_if_needed(target, logits.shape[-1]).to(logits.dtype)
    target = smooth_labels(target, label_smoothing)
    if softmax_before_ce:
        logits = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -(target * logp).sum(dim=-1)


def cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    label_smoothing: float = 0.0,
    softmax_before_ce: bool = False,
) -> torch.Tensor:
    """Mean soft-target cross entropy over the batch (torch CE with soft
    targets: mean over rows of ``-sum(target * logp)``)."""
    return cross_entropy_per_sample(
        logits, target, label_smoothing, softmax_before_ce).mean()
