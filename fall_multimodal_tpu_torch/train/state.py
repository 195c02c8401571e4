"""Train state: everything a training run mutates, in one object
(counterpart of the JAX package's ``train/state.py:18-73``).

JAX threads an immutable pytree through its steps; here the model and the
optimizer are updated in place, so a copy that must not move (the best
state of a run) is taken with :meth:`TrainState.snapshot`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Union

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer           # bound to ``model``'s parameters
    step: int                      # micro-steps taken (train-step calls)
    # every draw of a run, on the model's device: shuffles, augmentation and
    # the model's own train-mode draws (dropout, DropGraph, stochastic depth)
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def snapshot(self) -> "TrainState":
        """A copy with tensors of its own: the model and the optimizer are
        deep-copied together (the copy's optimizer is bound to the copy's
        parameters), the generator's state is cloned."""
        model, optimizer = copy.deepcopy((self.model, self.optimizer))
        generator = torch.Generator(self.device)
        generator.set_state(self.generator.get_state())
        return TrainState(model, optimizer, self.step, generator)


def create_train_state(
    model: Union[Config, nn.Module],
    optimizer: Optimizer,
    seed: int = 42,
    weight_init: str = "torch",
    device="cuda",
) -> TrainState:
    """A fresh state on ``device`` (the card unless the caller passes
    ``"cpu"``).

    ``model`` is a module or a config to build one from. ``weight_init``:
    "torch" (the reference's from-scratch init, torch module defaults),
    "init_param" (the reference's ``musa_model.py:408-420`` helper) or
    "flax" (the JAX package's flax defaults); each draws from generators
    seeded by ``seed`` (:func:`~fall_multimodal_tpu_torch.models.init.
    reinitialize`). Every later draw of the run (shuffles, augmentation, and
    the model's dropout, DropGraph and stochastic depth, which the train step
    passes the generator to) comes from the state's own generator on the
    device, seeded with ``seed``; nothing draws from torch's global
    generator, so a state snapshot repeats its steps exactly.
    """
    from fall_multimodal_tpu_torch.models import build_model
    from fall_multimodal_tpu_torch.models.init import reinitialize
    from fall_multimodal_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if isinstance(model, Config):
        model = build_model(model)
    model = reinitialize(model, seed=seed, scheme=weight_init).to(dev)
    generator = torch.Generator(dev).manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer.init(model.parameters()),
                      step=0, generator=generator)


def param_count(state: TrainState, exclude: str = "") -> int:
    """Trainable-parameter count; ``exclude`` skips parameters whose
    state_dict name contains the substring (the reference's count_params
    excludes ``fc``, ``musa_model.py:16-18``)."""
    return sum(p.numel() for name, p in state.model.named_parameters()
               if not exclude or exclude not in name)
