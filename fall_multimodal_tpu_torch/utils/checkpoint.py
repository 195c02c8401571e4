"""Checkpoints of a :class:`~fall_multimodal_tpu_torch.train.state.TrainState`
(counterpart of the JAX package's ``utils/checkpoint.py:22-86``).

Capability of the reference's two artifacts (``main.py:323-341``): ``best``
(saved on validation improvement) and ``latest`` (full resumable state).
Each is a directory holding one torch file, ``checkpoint.pt``:

* ``model``: the model's state_dict under the reference key names, so
  ``interop.load_state_dict_file("<dir>/best/checkpoint.pt")`` reads it and
  :class:`~fall_multimodal_tpu_torch.serve.Predictor` serves it;
* ``optimizer``: the optimizer's state (the torch optimizer's, plus the
  accumulation buffers and step counters);
* ``step``, ``epoch``, ``best_acc`` and the run generator's state, or an
  int seed for it (a checkpoint converted from the JAX package, whose
  ``jax.random`` key has no torch counterpart:
  ``experiments/convert_jax_checkpoint.py``).

Saving writes a temporary directory first and swaps it in; a crash inside
the swap leaves the previous checkpoint under ``<name>.prev``, which
:meth:`Checkpointer.restore` falls back to.
"""

from __future__ import annotations

import os
import shutil
from typing import Tuple

import torch

from fall_multimodal_tpu_torch.train.state import TrainState
from fall_multimodal_tpu_torch.utils.profiling import span

FILE = "checkpoint.pt"


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def file(self, name: str) -> str:
        """The checkpoint file of ``name`` ("best" | "latest"), or of its
        ``.prev`` copy when a crash landed inside a swap."""
        path = self._path(name)
        if not os.path.isdir(path) and os.path.isdir(self._path(f"{name}.prev")):
            path = self._path(f"{name}.prev")
        return os.path.join(path, FILE)

    def _save(self, name: str, state: TrainState, epoch: int, best_acc: float) -> None:
        """Write-then-swap: write to ``<name>.tmp``, move the old checkpoint
        aside, swap, then drop the old one. Under a profiler: a
        ``checkpoint.save`` span holding ``checkpoint.serialize`` (the write)
        and ``checkpoint.swap``."""
        with span("checkpoint.save"):
            final, tmp, prev = (self._path(name), self._path(f"{name}.tmp"),
                                self._path(f"{name}.prev"))
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with span("checkpoint.serialize"):
                torch.save({
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step),
                    "generator": state.generator.get_state(),
                    "epoch": int(epoch),
                    "best_acc": float(best_acc),
                }, os.path.join(tmp, FILE))
            with span("checkpoint.swap"):
                if os.path.isdir(prev):
                    shutil.rmtree(prev)
                if os.path.isdir(final):
                    os.rename(final, prev)
                os.rename(tmp, final)
                if os.path.isdir(prev):
                    shutil.rmtree(prev)

    def save_best(self, state: TrainState, epoch: int, best_acc: float) -> None:
        self._save("best", state, epoch, best_acc)

    def save_latest(self, state: TrainState, epoch: int, best_acc: float) -> None:
        self._save("latest", state, epoch, best_acc)

    def restore(self, name: str, template: TrainState) -> Tuple[TrainState, int, float]:
        """Load ``name`` ("best" | "latest") into ``template`` in place (its
        model, optimizer, step and generator) and return
        ``(template, epoch, best_acc)``. To keep another state unchanged,
        restore into its :meth:`~TrainState.snapshot`."""
        payload = torch.load(self.file(name), map_location=template.device,
                             weights_only=True)
        template.model.load_state_dict(payload["model"], strict=True)
        template.optimizer.load_state_dict(payload["optimizer"])
        template.step = int(payload["step"])
        generator = payload["generator"]
        if isinstance(generator, int):
            template.generator.manual_seed(generator)
        else:
            template.generator.set_state(generator.cpu())
        return template, int(payload["epoch"]), float(payload["best_acc"])

    def has(self, name: str) -> bool:
        return os.path.isdir(self._path(name)) or os.path.isdir(self._path(f"{name}.prev"))
