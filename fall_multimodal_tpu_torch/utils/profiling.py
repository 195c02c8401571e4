"""Profiling and observability hooks (counterpart of the JAX package's
``utils/profiling.py``).

Beyond the reference's wall-clock ETA instrumentation (``main.py:98,137-142``),
per-parameter gradient-norm TensorBoard scalars (``main.py:84-89``) and
``torchinfo.summary`` (``Multimodal_Fall3/main.py:326-328``):

* :func:`trace` — a ``torch.profiler`` trace of a block, written as a
  Chrome/Perfetto trace file;
* :func:`span` — a named range of the port's own work in that trace
  (``torch.profiler.record_function``) while a profiler runs, and a shared
  no-op otherwise. The port's ranges: ``predict_logits`` with
  ``predict.prep`` / ``.h2d`` / ``.launch`` / ``.d2h`` per chunk;
  ``fit.epoch`` with ``fit.shuffle`` / ``.train`` / ``.eval`` / ``.read`` /
  ``.snapshot``, or ``fit.chunk`` of fused epochs; ``train.step`` with
  ``step.gather`` / ``.forward`` / ``.backward`` / ``.optimizer``;
  ``checkpoint.save`` with ``checkpoint.serialize`` / ``.swap``;
  ``targcn.recurrence`` (one per graph-GRU layer), ``targcn.transformer``
  and ``targcn.head`` in a TARGCN forward. Counters for the same
  boundaries: ``serve.Predictor.calls``,
  ``train.loop.make_train_step.steps`` and
  ``models.targcn.GraphGRUCell.steps`` (frames stepped through);
* :class:`Throughput` — windows/s counter, in all and per card;
* :func:`global_norm` / :func:`grad_norms` — gradient telemetry that stays
  on the device (the caller reads it once per epoch), per fold over stacked
  fold states;
* :func:`model_summary` — parameter table per state_dict name;
* :func:`nan_debug` — raise at the first NaN that autograd produces.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator, Mapping, Union

import torch


class _NoSpan:
    """The context :func:`span` hands out while no profiler runs."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A range named ``name`` in the profiler's trace around a ``with``
    block of the port's own work, while a ``torch.profiler`` runs
    (:func:`trace`, or any caller's); the ranges nest as the blocks do and
    share the clock of the card's activities. With no profiler running it
    returns one shared no-op context: a flag read, no allocation. It adds no
    device synchronisation either way."""
    return torch.profiler.record_function(name) if _profiling() else _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (host operators, the port's :func:`span` ranges, and
    the card's kernels and copies when there is one) and write
    ``<log_dir>/trace.json``, viewable in Perfetto or ``chrome://tracing``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Running windows/s counter (the reference's ``cal_remaining_time``
    loop instrumentation); ``n_devices`` cards share the windows (a
    data-parallel run). Host clock: the caller synchronises the card before
    :meth:`update` when it times device work."""

    def __init__(self, n_devices: int = 1):
        self.n_devices = n_devices
        self.reset()

    def reset(self) -> None:
        self._windows = 0
        self._start = time.perf_counter()

    def update(self, n_windows: int) -> None:
        self._windows += n_windows

    @property
    def windows_per_sec(self) -> float:
        dt = time.perf_counter() - self._start
        return self._windows / dt if dt > 0 else 0.0

    @property
    def windows_per_sec_per_chip(self) -> float:
        return self.windows_per_sec / max(self.n_devices, 1)


def _norm(x: torch.Tensor, fold_axis: bool) -> torch.Tensor:
    """L2 norm of ``x``; with ``fold_axis`` one per slice of dim 0, as optax's
    norms are per fold under ``vmap``."""
    if fold_axis:
        return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)
    return torch.linalg.vector_norm(x)


def global_norm(tensors: Iterable[torch.Tensor], fold_axis: bool = False) -> torch.Tensor:
    """L2 norm over every element of every tensor, as one device scalar;
    with ``fold_axis`` (tensors stacked along a leading fold axis, K folds)
    the K folds' norms, shape ``(K,)``."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    if fold_axis:
        return _norm(torch.stack([_norm(t, True) for t in tensors], dim=1), True)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def grad_norms(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
               fold_axis: bool = False) -> Dict[str, torch.Tensor]:
    """Per-parameter L2 norms of the current gradients, keyed by the
    parameter's state_dict name (the reference's key names); ``params`` is a
    model or its named parameters. With ``fold_axis`` (stacked fold states)
    each norm is per fold, shape ``(K,)``."""
    named = params.named_parameters() if isinstance(params, torch.nn.Module) \
        else params.items()
    return {name: _norm(p.grad.detach(), fold_axis)
            for name, p in named if p.grad is not None}


def model_summary(model: torch.nn.Module) -> str:
    """Parameter table: name, shape, count (``torchinfo.summary`` capability)."""
    lines = [f"{'path':<64}{'shape':<20}{'params':>12}"]
    total = 0
    for name, param in model.named_parameters():
        n = param.numel()
        total += n
        lines.append(f"{name:<64}{str(tuple(param.shape)):<20}{n:>12,}")
    lines.append(f"{'TOTAL':<84}{total:>12,}")
    return "\n".join(lines)


@contextlib.contextmanager
def nan_debug(enable: bool = True) -> Iterator[None]:
    """Inside the block, autograd raises at the first backward operation that
    returns NaN (``torch.autograd.set_detect_anomaly(check_nan=True)``); the
    caller's setting is put back on the way out."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield
