"""Plain PyTorch reference of one training step of the reference repository's
recipe (``main.py`` of ``Fall_2_Spatial_Temporal_SR``, the GSTCAN notebooks):

1. forward in train mode (batch statistics);
2. with ``softmax_output``, the notebook's softmax on the logits *before*
   ``CrossEntropyLoss``, which then takes a log-softmax of the
   probabilities; the loss is the mean over rows of ``-sum(target * logp)``
   with the soft targets as given;
3. backward;
4. the gradient clipped by its global L2 norm: scaled by ``max_norm / norm``
   where ``norm >= max_norm``;
5. RMSprop as ``torch.optim.RMSprop`` defines it, no momentum, no weight
   decay: ``s <- alpha * s + (1 - alpha) * g^2``,
   ``p <- p - lr * g / (sqrt(s) + eps)``, written out here.

Imports nothing but ``torch``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn


class Trainer:
    """Holds the model and the squared averages; :meth:`step` trains one
    batch and returns its loss and the gradient the update took (after
    clipping), by parameter name."""

    def __init__(self, model: nn.Module, optim: dict, train: dict, softmax_output: bool,
                 loss_fn=None):
        if optim["type"] != "rmsprop" or optim.get("momentum", 0) or optim.get("weight_decay", 0):
            raise ValueError(f"this reference trains plain RMSprop, got {optim}")
        self.model = model
        self.lr, self.alpha, self.eps = optim["lr"], optim["rms_decay"], optim["eps"]
        self.max_norm = train["max_norm"]
        self.softmax_output = softmax_output
        self.loss_fn = loss_fn or self.loss
        self.params = dict(model.named_parameters())
        self.square_avg = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.softmax_output:
            logits = torch.softmax(logits, dim=-1)
        return -(target * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()

    def step(self, skeleton, sensor, target) -> Tuple[float, Dict[str, torch.Tensor]]:
        self.model.train()
        for p in self.params.values():
            p.grad = None
        loss = self.loss_fn(self.model(skeleton, sensor), target)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                 for k, p in self.params.items()}
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            if norm >= self.max_norm:
                grads = {k: g * (self.max_norm / norm).float() for k, g in grads.items()}
            for k, p in self.params.items():
                s = self.square_avg[k]
                s.mul_(self.alpha).add_((1 - self.alpha) * grads[k] * grads[k])
                p.sub_(self.lr * grads[k] / (torch.sqrt(s) + self.eps))
        return float(loss.detach()), grads
