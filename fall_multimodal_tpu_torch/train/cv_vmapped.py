"""Fold-parallel cross-validation: all K folds train at once (counterpart of
the JAX package's ``train/cv_vmapped.py``).

The dataset goes to the device once and each fold is an index set. The K
folds' train states are stacked along a leading fold axis
(``torch.func.stack_module_state``: parameters, BatchNorm statistics and the
optimizer's state all carry it). A step gathers K batches in one index, runs
the K train-mode forwards as one ``torch.func.vmap`` over ``functional_call``
(a fold's convolutions become one grouped convolution, its matmuls one
batched matmul), then one backward of the K losses summed: the folds share
no parameter, so each gets its own gradient. One optimizer over the stacked
tensors makes the K updates (every rule is elementwise; clipping takes each
fold's own norm, :meth:`~fall_multimodal_tpu_torch.train.optim.Optimizer.
init` with ``fold_axis=True``). So a step issues one set of launches for K
folds' work. ``aten::lstm`` has no batching rule: the BiLSTM runs one cuDNN
call per fold (``models/layers.py:_FoldBatchedBiLSTM``). No op may fall
back to functorch's per-example loop: a missing batching rule raises
(:func:`strict_vmap`).

As in the JAX package, the folds share one ``(steps, batch)`` index matrix
shape: ``steps = min fold train size // batch``, larger folds take a fresh
random subset each epoch, and a fold smaller than ``steps * batch`` wraps
around. The index matrices come from ``np.random.default_rng(config.seed)``
as the JAX package draws them, so the batches are the JAX package's.

Train-mode draws (dropout, DropGraph, stochastic depth, augmentation) come
from one generator seeded with ``config.seed`` under
``vmap(randomness="different")``: every fold draws its own. They equal
neither the JAX package's draws (``jax.random`` is another stream) nor the
sequential driver's; a family that draws nothing (the flagship, ``stgcan``,
``bilstm`` with augmentation off) is exact.

``mesh`` (a fold mesh, :func:`~fall_multimodal_tpu_torch.parallel.mesh.
make_mesh` with ``axis="fold"``): the fold axis is cut into one group of
K/N folds per device, each with its own copy of the dataset and its own
generator (seeded ``config.seed`` plus its first fold), stepped in turn from
one process with no collective, so N cards run together.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call, stack_module_state, vmap

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.data.augment import make_augment_fn
from fall_multimodal_tpu_torch.data.pipeline import DeviceData, gather_batch, to_device
from fall_multimodal_tpu_torch.data.splits import kfold_indices, stratified_kfold_indices
from fall_multimodal_tpu_torch.data.synthetic import WindowedDataset
from fall_multimodal_tpu_torch.train.cv import cv_results, fold_row
from fall_multimodal_tpu_torch.train.losses import cross_entropy_per_sample
from fall_multimodal_tpu_torch.train.loop import _precision
from fall_multimodal_tpu_torch.train.metrics import prf_from_confusion
from fall_multimodal_tpu_torch.train.optim import Optimizer, build_optimizer
from fall_multimodal_tpu_torch.train.state import TrainState, create_train_state
from fall_multimodal_tpu_torch.utils.device import full_float32, resolve_device
from fall_multimodal_tpu_torch.utils.profiling import grad_norms as _grad_norms


@contextlib.contextmanager
def strict_vmap():
    """Inside the block an op without a batching rule raises instead of
    running functorch's per-example loop (which only warns)."""
    saved = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(saved)


@dataclasses.dataclass
class FoldStates:
    """K train states stacked along a leading fold axis: ``model`` is the
    structure that ``functional_call`` runs (fold 0's module), ``params`` and
    ``buffers`` its tensors with a fold axis in front, ``optimizer`` bound to
    ``params`` over that axis, ``generator`` every train-mode draw's."""

    model: nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {**self.params, **self.buffers}

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.tensors().items()}


def stack_states(states: List[TrainState], optimizer: Optimizer,
                 generator: torch.Generator) -> FoldStates:
    """The states' models stacked along a fold axis, ``optimizer`` bound to
    the stacked parameters (in the models' parameter order)."""
    params, buffers = stack_module_state([s.model for s in states])
    return FoldStates(model=states[0].model, params=params, buffers=buffers,
                      optimizer=optimizer.init(params.values(), fold_axis=True),
                      generator=generator)


def load_fold(folds: FoldStates, k: int, state: TrainState) -> TrainState:
    """Fold ``k`` of ``folds`` copied into ``state`` (a single-fold state of
    the same config): weights, statistics, the optimizer's state and step
    counts; the state is then where fold ``k`` is."""
    def part(value):
        return value[k].clone() if torch.is_tensor(value) and value.dim() > 0 else value

    state.model.load_state_dict({name: t[k] for name, t in folds.tensors().items()})
    saved = folds.optimizer.state_dict()
    saved["inner"]["state"] = {i: {key: part(v) for key, v in st.items()}
                               for i, st in saved["inner"]["state"].items()}
    if saved["acc"] is not None:
        saved["acc"] = [a[k] for a in saved["acc"]]
    state.optimizer.load_state_dict(saved)
    state.step = folds.step
    return state


def _fold_batch(data: DeviceData, idx: torch.Tensor) -> DeviceData:
    """The ``(K, B)`` batches of ``idx`` in one gather, ``(K, B, ...)``."""
    flat = gather_batch(data, idx.reshape(-1))
    return DeviceData(*(t.view(*idx.shape, *t.shape[1:]) for t in flat))


def make_fold_train_step(label_smoothing: float = 0.0, softmax_before_ce: bool = False,
                         compute_dtype: Optional[torch.dtype] = None,
                         grad_norms: bool = False, augment_fn=None):
    """``step(folds, data, idx (K, B)) -> (folds, {loss (K,), accuracy (K,)[,
    grad_norms]})``: one optimizer step of every fold, as the sequential
    :func:`~fall_multimodal_tpu_torch.train.loop.make_train_step` takes it
    (the same loss, precision and update), vmapped over the fold axis."""

    def step(folds: FoldStates, data: DeviceData, idx: torch.Tensor):
        model = folds.model.train()
        batch = _fold_batch(data, idx)
        gen = folds.generator

        def forward(params, buffers, feats, sens):
            if augment_fn is not None:
                feats, sens = augment_fn(gen, feats, sens)
            return functional_call(model, (params, buffers), (feats, sens), {"generator": gen})

        with full_float32() if compute_dtype is None else contextlib.nullcontext():
            with _precision(compute_dtype, gen.device), strict_vmap():
                logits = vmap(forward, randomness="different")(
                    folds.params, folds.buffers, batch.features, batch.sensors)
            per_sample = cross_entropy_per_sample(
                logits.float().flatten(0, 1), batch.labels.flatten(0, 1),
                label_smoothing, softmax_before_ce)
            losses = per_sample.view(idx.shape).mean(1)
            folds.optimizer.zero_grad()
            losses.sum().backward()
            metrics: Dict[str, Any] = {}
            if grad_norms:
                metrics["grad_norms"] = _grad_norms(folds.params, fold_axis=True)
            folds.optimizer.step()
        folds.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch.labels.argmax(-1)).float().mean(1)
        metrics.update(loss=losses.detach(), accuracy=acc)
        return folds, metrics

    return step


def make_fold_eval(num_classes: int, label_smoothing: float = 0.0,
                   softmax_before_ce: bool = False):
    """``evaluate(model, tensors, data, idx (K, S, B), mask (K, S, B)) ->
    (confusion (K, C, C), loss_sum (K,))``: every fold's eval-mode forward
    over its padded batches (running statistics, full float32), vmapped
    over the fold axis; ``tensors`` are stacked parameters and buffers."""

    def evaluate(model: nn.Module, tensors: Dict[str, torch.Tensor], data: DeviceData,
                 idx: torch.Tensor, mask: torch.Tensor):
        k, c = idx.shape[0], num_classes
        dev = data.features.device
        offset = torch.arange(k, device=dev)[:, None] * c * c
        cm = torch.zeros(k * c * c, device=dev)
        loss_sum = torch.zeros(k, device=dev)
        model.eval()
        try:
            with torch.no_grad(), full_float32(), strict_vmap():
                for s in range(idx.shape[1]):
                    batch = _fold_batch(data, idx[:, s])
                    logits = vmap(lambda t, f, se: functional_call(model, t, (f, se)))(
                        tensors, batch.features, batch.sensors)
                    target = batch.labels.argmax(-1)
                    flat = offset + target * c + logits.argmax(-1)
                    cm += torch.bincount(flat.reshape(-1), weights=mask[:, s].reshape(-1),
                                         minlength=k * c * c)
                    per_sample = cross_entropy_per_sample(
                        logits.flatten(0, 1), batch.labels.flatten(0, 1),
                        label_smoothing, softmax_before_ce).view(idx.shape[0], -1)
                    loss_sum += (per_sample * mask[:, s]).sum(1)
        finally:
            model.train()
        return cm.view(k, c, c), loss_sum

    return evaluate


def fold_indices(config: Config, data: WindowedDataset, n_folds: int):
    """The folds' index sets, stratified or by video as the config says (the
    JAX package's ``cv_vmapped.py:97-106``)."""
    if config.data.stratify_folds:
        return stratified_kfold_indices(data.labels, n_folds=n_folds, seed=config.seed)
    return kfold_indices(data.videos, n_folds=n_folds, seed=config.seed,
                         by_video=config.data.split_by_video)


def epoch_index_matrix(rng: np.random.Generator, folds, steps: int, batch: int) -> np.ndarray:
    """One epoch's ``(K, steps, batch)`` shuffled train indices, drawn from
    ``rng`` exactly as the JAX package's ``epoch_indices`` draws them
    (``cv_vmapped.py:240-255``), wraparound for small folds included."""
    idx = np.zeros((len(folds), steps, batch), np.int64)
    need = steps * batch
    for k, f in enumerate(folds):
        perm = rng.permutation(f["train"])
        if need > len(perm):
            perm = np.tile(perm, -(-need // len(perm)))
        idx[k] = perm[:need].reshape(steps, batch)
    return idx


def eval_index_matrices(folds, batch: int):
    """Per-fold padded ``(K, S, batch)`` eval indices and masks over each
    fold's test set, with a common step count."""
    steps = max(-(-len(f["test"]) // batch) for f in folds)
    flat = np.arange(steps * batch)
    idx = np.stack([f["test"][np.minimum(flat, len(f["test"]) - 1)] for f in folds])
    mask = np.stack([flat < len(f["test"]) for f in folds]).astype(np.float32)
    return idx.reshape(len(folds), steps, batch), mask.reshape(len(folds), steps, batch)


def cross_validate_vmapped(
    config: Config,
    data: WindowedDataset,
    n_folds: Optional[int] = None,
    epochs: Optional[int] = None,
    logger=None,
    mesh=None,
    grad_norms: bool = False,
    metrics_factory=None,
    step_metrics_factory=None,
    scan_epochs=None,
    device="cuda",
) -> Dict[str, Any]:
    """K-fold CV with every fold trained in one vmapped step on ``device``
    (the card unless the caller passes ``"cpu"``), or over a fold ``mesh``.
    Returns ``cross_validate``'s structure: ``{"folds": [per-fold rows],
    "summary": {"<metric>_mean", "<metric>_std"}}``.

    ``train.dtype: bfloat16`` runs the forwards under autocast.
    ``grad_norms`` with ``step_metrics_factory(k)`` streams fold ``k``'s
    per-parameter gradient norms per step, read once per epoch;
    ``metrics_factory(k)`` gets fold ``k``'s epoch curves. ``scan_epochs``
    (the whole run as one device program) and ``train.epoch_impl: scan``
    have no counterpart in the port and raise; None picks the per-epoch
    host driver.
    """
    if scan_epochs or config.train.epoch_impl not in ("auto", "host"):
        raise ValueError(
            "scan_epochs / epoch_impl='scan' fuse epochs into one device program; the "
            "PyTorch port drives every step from the host and has no counterpart yet")
    n_folds = n_folds or config.data.n_folds
    epochs = epochs or config.train.epochs
    batch = config.train.batch_size
    num_classes = data.num_classes
    folds = fold_indices(config, data, n_folds)
    if mesh is None:
        devices = [torch.empty(0, device=resolve_device(device)).device]
    else:
        devices = list(mesh.devices)
        if n_folds % len(devices):
            raise ValueError(f"n_folds={n_folds} must divide evenly over the "
                             f"{len(devices)}-device mesh")
    groups = np.array_split(np.arange(n_folds), len(devices))

    steps = max(1, min(len(f["train"]) for f in folds) // batch)
    optimizer = build_optimizer(config.optim, scheduler=config.lr_scheduler,
                                steps_per_epoch=steps, max_norm=config.train.max_norm,
                                accum_iter=config.train.accum_iter)
    shards, shard_data = [], []
    for dev, group in zip(devices, groups):
        states = [create_train_state(config, optimizer, seed=config.seed + int(k),
                                     weight_init=config.model.weight_init, device=dev)
                  for k in group]
        generator = torch.Generator(dev).manual_seed(config.seed + int(group[0]))
        shards.append(stack_states(states, optimizer, generator))
        shard_data.append(to_device(data, dev))
    compute_dtype = torch.bfloat16 if config.train.dtype == "bfloat16" else None
    train_step = make_fold_train_step(
        config.train.label_smoothing, config.model.softmax_output, compute_dtype,
        grad_norms=grad_norms,
        augment_fn=make_augment_fn(config.augment, config.graph.layout))
    evaluate = make_fold_eval(num_classes, config.train.label_smoothing,
                              config.model.softmax_output)
    eval_idx, eval_mask = eval_index_matrices(folds, batch)
    eval_counts = eval_mask.sum((1, 2))
    eval_parts = [(torch.as_tensor(eval_idx[g], device=d), torch.as_tensor(eval_mask[g], device=d))
                  for d, g in zip(devices, groups)]

    def eval_all(tensors_per_shard):
        out = [evaluate(fs.model, tensors, d, *part) for fs, tensors, d, part
               in zip(shards, tensors_per_shard, shard_data, eval_parts)]
        cms = torch.cat([cm.cpu() for cm, _ in out]).numpy()
        return cms, torch.cat([loss.cpu() for _, loss in out]).numpy()

    rng = np.random.default_rng(config.seed)
    best_acc = np.full(n_folds, -1.0)
    best = [fs.snapshot() for fs in shards]
    epoch_s = 0.0
    for epoch_i in range(1, epochs + 1):
        t0 = time.perf_counter()
        idx = epoch_index_matrix(rng, folds, steps, batch)
        parts = [torch.as_tensor(idx[g], device=d) for d, g in zip(devices, groups)]
        step_metrics: List[List[Dict[str, Any]]] = [[] for _ in shards]
        for s in range(steps):
            # one step of every shard before the next: the devices run together
            for fs, d, part, out in zip(shards, shard_data, parts, step_metrics):
                out.append(train_step(fs, d, part[:, s])[1])
        train_loss = torch.cat([torch.stack([m["loss"] for m in out]).mean(0).cpu()
                                for out in step_metrics]).numpy()
        train_acc = torch.cat([torch.stack([m["accuracy"] for m in out]).mean(0).cpu()
                               for out in step_metrics]).numpy()
        if grad_norms and step_metrics_factory is not None:
            names = list(step_metrics[0][0]["grad_norms"])
            norms = {n: torch.cat([torch.stack([m["grad_norms"][n] for m in out], 1).cpu()
                                   for out in step_metrics]).numpy() for n in names}
            base = (epoch_i - 1) * steps
            for k in range(n_folds):
                cb = step_metrics_factory(k)
                if cb is None:
                    continue
                for s in range(steps):
                    cb(base + s, {f"grad_norm/{n}": float(v[k, s]) for n, v in norms.items()})
        cms, loss_sums = eval_all([fs.tensors() for fs in shards])
        accs = np.trace(cms, axis1=1, axis2=2) / np.maximum(cms.sum((1, 2)), 1.0)
        epoch_s += time.perf_counter() - t0       # train and eval, read back to the host
        if metrics_factory is not None:
            for k in range(n_folds):
                cb = metrics_factory(k)
                if cb is not None:
                    cb(epoch_i, {"train_loss": float(train_loss[k]),
                                 "train_accuracy": float(train_acc[k]),
                                 "val_loss": float(loss_sums[k] / eval_counts[k]),
                                 "val_accuracy": float(accs[k])})
        # a fold whose training blew up (non-finite loss, constant predictions)
        # promotes neither its state nor its accuracy
        improved = (accs > best_acc) & np.isfinite(train_loss)
        if improved.any():
            for i, (fs, g) in enumerate(zip(shards, groups)):
                gate = torch.as_tensor(improved[g], device=devices[i])
                best[i] = {name: torch.where(gate.view(-1, *[1] * (new.dim() - 1)),
                                             new.detach(), best[i][name])
                           for name, new in fs.tensors().items()}
            best_acc = np.where(improved, accs, best_acc)
        if logger and epoch_i % 10 == 0:
            logger.info(f"[vmapped CV] epoch {epoch_i}/{epochs} mean val acc "
                        f"{accs.mean():.4f} (best {best_acc.mean():.4f})")

    cms, _ = eval_all(best)
    if logger:
        logger.info(f"[vmapped CV] {epochs} epochs x {n_folds} folds on {len(devices)} "
                    f"device(s) in {epoch_s:.3f} s of epochs; mean best val acc "
                    f"{best_acc.mean():.4f}")
    return cv_results([fold_row(k, best_acc[k], prf_from_confusion(cms[k]))
                       for k in range(n_folds)])
