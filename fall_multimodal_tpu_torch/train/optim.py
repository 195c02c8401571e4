"""Optimizer + LR-schedule factory (counterpart of the JAX package's
``train/optim.py:48-174``).

Capability parity with the reference factories
(``Fall_2_Spatial_Temporal_SR/optimizer.py:8-35``,
``Multimodal_Fall3/optimizer.py:8-31``): sgd / adam / adamw / rmsprop and
step / multistep / cosine-with-warmup schedules. The updates are
``torch.optim``'s; around them :class:`Optimizer` keeps the JAX package's
optax chain in its order:

1. ``accum_iter`` micro-steps are averaged (optax ``MultiSteps``, Welford
   mean) before one update; in between the parameters do not move;
2. the (averaged) gradient is clipped by its global norm the way optax
   clips: scaled by ``max_norm / norm`` only when ``norm >= max_norm``
   (``torch.nn.utils.clip_grad_norm_`` would divide by ``norm + 1e-6``);
   over parameters stacked along a fold axis (``init(..., fold_axis=True)``)
   each fold is clipped by its own norm, as optax clips under ``vmap``;
3. weight decay is added to the gradient inside the torch update (for
   rmsprop before the square average, as ``optim.py:150-162`` chains it);
4. the learning rate of update ``g`` (counted in gradient steps, not
   micro-steps) is ``schedule(g)``.

``torch.optim.RMSprop(alpha=rms_decay, eps=eps)`` is the JAX package's
``scale_by_torch_rms`` (``s <- a*s + (1-a)*g^2; p <- p - lr*g/(sqrt(s)+eps)``);
the port's tests hold the two against each other.

Every update rule here, weight decay and the accumulation are elementwise,
so one optimizer over K folds' stacked parameters makes the K folds'
updates independently (one schedule: the folds take equal steps).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Iterable, List, Optional, Union

import torch

from fall_multimodal_tpu_torch.configs import Config, OptimConfig, SchedulerConfig
from fall_multimodal_tpu_torch.utils.profiling import global_norm

Schedule = Callable[[int], float]


def build_schedule(cfg: SchedulerConfig, base_lr: float,
                   steps_per_epoch: int = 1) -> Union[float, Schedule]:
    """Epoch-granular schedules applied per optimizer step.

    The reference steps its scheduler once per epoch (``main.py:321-322``);
    the step count is floored to an epoch index (timm semantics).
    """
    if cfg.type is None:
        return base_lr

    def warmup_lr(epoch):
        # timm warmup: lr = warmup_lr_init + t * (base - init) / warmup_t
        return cfg.warmup_lr_init + epoch * (base_lr - cfg.warmup_lr_init) / max(
            cfg.warmup_t, 1)

    if cfg.type == "cosine":
        # timm CosineLRScheduler (t_in_epochs=True, cycle_limit=1,
        # warmup_prefix=False): linear warmup for t < warmup_t, then cosine
        # at the UNSHIFTED epoch index, lr_min once the cycle ends.
        def schedule(step):
            epoch = math.floor(step / steps_per_epoch)
            if epoch < cfg.warmup_t:
                return warmup_lr(epoch)
            if epoch >= cfg.t_initial:
                return cfg.lr_min
            return cfg.lr_min + 0.5 * (base_lr - cfg.lr_min) * (
                1 + math.cos(math.pi * epoch / cfg.t_initial))

        return schedule

    if cfg.type == "step":
        # timm StepLRScheduler: base * decay_rate ** (t // decay_t)
        def schedule(step):
            epoch = math.floor(step / steps_per_epoch)
            if cfg.warmup_t > 0 and epoch < cfg.warmup_t:
                return warmup_lr(epoch)
            return base_lr * cfg.decay_rate ** math.floor(epoch / max(cfg.t_initial, 1))

        return schedule

    if cfg.type == "multistep":
        # timm MultiStepLRScheduler: base * rate ** bisect_right(decay_t, t)
        def schedule(step):
            epoch = math.floor(step / steps_per_epoch)
            if cfg.warmup_t > 0 and epoch < cfg.warmup_t:
                return warmup_lr(epoch)
            return base_lr * cfg.decay_rate ** sum(epoch >= b for b in cfg.decay_steps)

        return schedule

    raise ValueError(f"Unknown LR scheduler type: {cfg.type!r}")


class Optimizer:
    """The update rule, built unbound by :func:`build_optimizer` (as an optax
    transformation is); :meth:`init` returns a copy bound to a model's
    parameters, and the bound copy is what a train state holds.

    A train step calls :meth:`zero_grad`, ``loss.backward()``, then
    :meth:`step`, which returns whether the parameters moved (False on the
    micro-steps of an accumulation).
    """

    def __init__(self, make: Callable[[List[torch.Tensor], float], torch.optim.Optimizer],
                 lr: Union[float, Schedule], max_norm: Optional[float] = None,
                 accum_iter: int = 1):
        self._make = make
        self.lr = lr
        self.max_norm = max_norm if max_norm is not None and max_norm > 0 else None
        self.accum_iter = max(1, int(accum_iter or 1))
        self.params: List[torch.Tensor] = []
        self.inner: Optional[torch.optim.Optimizer] = None
        self.acc: Optional[List[torch.Tensor]] = None
        self.mini_step = 0          # micro-steps into the current accumulation
        self.gradient_step = 0      # updates applied so far
        self.fold_axis = False      # parameters stacked along a leading fold axis

    def lr_at(self, gradient_step: int) -> float:
        return float(self.lr(gradient_step)) if callable(self.lr) else float(self.lr)

    def init(self, params: Iterable[torch.Tensor], fold_axis: bool = False) -> "Optimizer":
        bound = copy.copy(self)
        bound.fold_axis = fold_axis
        bound.params = [p for p in params if p.requires_grad]
        bound.inner = self._make(bound.params, bound.lr_at(0))
        bound.acc = ([torch.zeros_like(p) for p in bound.params]
                     if self.accum_iter > 1 else None)
        bound.mini_step = bound.gradient_step = 0
        return bound

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _clip(self, grads: List[torch.Tensor]) -> None:
        """optax ``clip_by_global_norm``: ``g * max_norm / norm`` where
        ``norm >= max_norm``, ``g`` unchanged below; stays on the device.
        Over a fold axis, each fold by its own norm."""
        norm = global_norm(grads, fold_axis=self.fold_axis)
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        if not self.fold_axis:
            torch._foreach_mul_(grads, scale)
            return
        for g in grads:
            g.mul_(scale.view(-1, *[1] * (g.dim() - 1)))

    @torch.no_grad()
    def step(self) -> bool:
        if self.inner is None:
            raise RuntimeError("Optimizer.step on an unbound optimizer; call init(params)")
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.acc is not None:
            # optax MultiSteps: Welford mean of the micro-step gradients
            inv = 1.0 / (self.mini_step + 1)
            for a, p in zip(self.acc, self.params):
                a.add_(p.grad - a, alpha=inv)
            self.mini_step += 1
            if self.mini_step < self.accum_iter:
                return False
            for a, p in zip(self.acc, self.params):
                p.grad.copy_(a)
                a.zero_()
            self.mini_step = 0
        if self.max_norm is not None:
            self._clip([p.grad for p in self.params])
        lr = self.lr_at(self.gradient_step)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.gradient_step += 1
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("checkpointed optimizer and this one differ in accum_iter")
        if self.acc is not None:
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)


def build_optimizer(
    cfg: Union[Config, OptimConfig],
    scheduler: Optional[SchedulerConfig] = None,
    steps_per_epoch: int = 1,
    max_norm: Optional[float] = None,
    accum_iter: int = 1,
) -> Optimizer:
    if isinstance(cfg, Config):
        scheduler = cfg.lr_scheduler
        max_norm = cfg.train.max_norm
        accum_iter = cfg.train.accum_iter
        cfg = cfg.optim
    # the schedule advances once per GRADIENT step (every accum_iter
    # micro-steps) while steps_per_epoch arrives in micro-steps: pace it in
    # gradient steps so one schedule epoch stays one data epoch
    schedule_steps = steps_per_epoch
    if accum_iter and accum_iter > 1:
        schedule_steps = max(1, steps_per_epoch // accum_iter)
    lr = build_schedule(scheduler or SchedulerConfig(), cfg.lr, schedule_steps)
    wd = cfg.weight_decay or 0.0

    if cfg.type == "sgd":
        def make(params, lr0):
            return torch.optim.SGD(params, lr=lr0, momentum=cfg.momentum or 0.0,
                                   weight_decay=wd)
    elif cfg.type == "adam":
        def make(params, lr0):
            return torch.optim.Adam(params, lr=lr0, betas=tuple(cfg.betas), eps=cfg.eps,
                                    weight_decay=wd)
    elif cfg.type == "adamw":
        def make(params, lr0):
            return torch.optim.AdamW(params, lr=lr0, betas=tuple(cfg.betas), eps=cfg.eps,
                                     weight_decay=wd)
    elif cfg.type in ("rmsprop", "rms"):
        def make(params, lr0):
            return torch.optim.RMSprop(params, lr=lr0, alpha=cfg.rms_decay, eps=cfg.eps,
                                       weight_decay=wd)
    else:
        raise ValueError(f"Unknown optimizer type: {cfg.type!r}")
    return Optimizer(make, lr, max_norm=max_norm, accum_iter=accum_iter)
