"""Seeded weights, made on the device in one draw and handed to both sides.

``scheme="init"`` is the published recipe's starting point (torch's module
defaults): convolution and linear weights and biases ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``, LSTM tensors ``U(-1/sqrt(H), 1/sqrt(H))``, normalisation
scales 1 and shifts 0, edge importance 1, running statistics 0 and 1.

``scheme="trained"`` stands for a trained model: the same weights, plus
normalisation scales ``1 + 0.2u``, shifts ``0.2u`` and edge importance
``1 + 0.2u`` (``u`` uniform in [-1, 1]), and running statistics taken from
one train-mode forward over ``condition`` (momentum 1), so that every layer
of the eval forward sees inputs of order one.

Parameters that no module-type rule covers (a family's raw
``nn.Parameter`` leaves, such as TARGCN's node embeddings and weight pools)
are drawn where the configuration's reference module yields them from its
``raw_leaves(model, scheme)``, after the module-type leaves and from the
same draw; a hook keeps a constant by yielding it with scale 0. A parameter
of two or more dimensions that neither a rule nor the hook yields is
refused: left at its constructor's value (zeros, ones), it makes a
degenerate model that a reference leaving it out would match. Only edge
importance under ``"init"`` stays at its constructor's 1 unyielded, as the
recipe has it.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

SCHEMES = ("init", "trained")


def _leaves(model: nn.Module, scheme: str):
    """``(tensor, scale, offset)``: the tensor becomes ``offset + scale * u``."""
    for mod_name, module in model.named_modules():
        if isinstance(module, nn.LSTM):
            bound = 1.0 / math.sqrt(module.hidden_size)
            for p in module.parameters(recurse=False):
                yield p, bound, 0.0
        elif isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            yield w, 1.0 / math.sqrt(fan_in), 0.0
            if module.bias is not None:
                yield module.bias, 1.0 / math.sqrt(fan_in), 0.0
        elif hasattr(module, "running_mean") and isinstance(getattr(module, "weight", None),
                                                            nn.Parameter):
            if scheme == "trained":
                yield module.weight, 0.2, 1.0
                yield module.bias, 0.2, 0.0
        elif mod_name.endswith("edge_importance") and scheme == "trained":
            for p in module.parameters():
                yield p, 0.2, 1.0


def _kept(name: str, scheme: str) -> bool:
    """The parameter keeps its constructor's value on purpose."""
    return scheme == "init" and "edge_importance" in name.split(".")


@torch.no_grad()
def seed_weights(model: nn.Module, seed: int, scheme: str,
                 condition: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
                 reference: Optional[ModuleType] = None) -> Dict[str, torch.Tensor]:
    """Draw ``model``'s weights in place from ``seed`` with one call to the
    device's generator and return its state_dict (tensors on its device).
    ``condition``: the ``(skeleton, sensor)`` batch whose statistics become
    the running statistics (``scheme="trained"``). ``reference``: the
    configuration's reference module, whose ``raw_leaves`` (if it has one)
    yields the parameters no module-type rule draws."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    leaves = list(_leaves(model, scheme))
    raw_leaves = getattr(reference, "raw_leaves", None)
    if raw_leaves is not None:
        leaves += list(raw_leaves(model, scheme))
    drawn = {id(t) for t, _, _ in leaves}
    for name, p in model.named_parameters():
        if p.dim() >= 2 and id(p) not in drawn and not _kept(name, scheme):
            raise ValueError(
                f"parameter {name!r} {tuple(p.shape)} is drawn by no module-type rule: yield "
                f"it from raw_leaves(model, scheme) in the configuration's reference module")
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(t.numel() for t, _, _ in leaves)
    u = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    at = 0
    for t, scale, offset in leaves:
        t.copy_(u[at:at + t.numel()].view_as(t) * scale + offset)
        at += t.numel()
    if scheme == "trained":
        if condition is None:
            raise ValueError("scheme 'trained' takes a condition batch for the statistics")
        norms = [m for m in model.modules() if hasattr(m, "running_mean")]
        saved = [m.momentum for m in norms]
        for m in norms:
            m.momentum = 1.0
        model.train()(*condition)
        for m, mom in zip(norms, saved):
            m.momentum = mom
            m.num_batches_tracked.zero_()
    model.eval()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
