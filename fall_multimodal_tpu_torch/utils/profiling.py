"""Gradient telemetry (counterpart of the JAX package's
``utils/profiling.py:69-91``): the reference logged one TensorBoard scalar per
parameter each optimizer step (``main.py:84-89``). Norms stay on the device;
the caller reads them once per epoch."""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every element of every tensor, as one device scalar."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def grad_norms(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Per-parameter L2 norms of the current gradients, keyed by the
    parameter's state_dict name (the reference's key names)."""
    return {name: torch.linalg.vector_norm(p.grad.detach())
            for name, p in model.named_parameters() if p.grad is not None}
