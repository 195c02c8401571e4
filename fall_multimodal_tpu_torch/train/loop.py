"""Training / evaluation engine (counterpart of the JAX package's
``train/loop.py:50-298,328-628``).

The JAX package runs an epoch as one jitted ``lax.scan`` on the TPU; its
``epoch_impl="host"`` drives the same jitted step from a Python loop. The
port drives its step from Python, which is the counterpart of ``"host"``:
every step's forward, backward and update are launched from the host, the
batch is gathered on the device from a ``(steps, batch)`` index matrix, and
the metrics stay on the device until one read per epoch. ``"scan"`` (and
``scan_epochs``, the whole run as one device program) have no counterpart
yet and raise.

Float32 means float32: with ``compute_dtype=None`` a train step and an eval
epoch run with cuDNN's and cuBLAS's TF32 switches off and the caller's
switches restored after (:func:`~fall_multimodal_tpu_torch.utils.device.
full_float32`). ``compute_dtype=torch.bfloat16`` runs the forward under
``torch.autocast`` with float32 master weights and a float32 loss.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fall_multimodal_tpu_torch.data.pipeline import (
    DeviceData,
    epoch_batch_indices,
    eval_batch_indices,
    eval_batch_mask,
    gather_batch,
)
from fall_multimodal_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    global_batch_stats,
    local_rows,
    replicate_data,
    replicate_state,
)
from fall_multimodal_tpu_torch.train.losses import cross_entropy, cross_entropy_per_sample
from fall_multimodal_tpu_torch.train.metrics import prf_from_confusion
from fall_multimodal_tpu_torch.train.state import TrainState
from fall_multimodal_tpu_torch.utils.device import full_float32
from fall_multimodal_tpu_torch.utils.profiling import Throughput

EMPTY_SPLIT = ("evaluate() got an empty split (0 windows) — the dataset is too "
               "small for the configured split fractions / fold count")


class EvalResult(NamedTuple):
    loss: float
    accuracy: float
    confusion: np.ndarray
    stats: Dict[str, Any]


def _precision(compute_dtype: Optional[torch.dtype], device: torch.device):
    """The forward's numeric context: full float32, or autocast to
    ``compute_dtype``."""
    if compute_dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=compute_dtype)


def make_train_step(
    label_smoothing: float = 0.0,
    softmax_before_ce: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    grad_norms: bool = False,
    augment_fn=None,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, DeviceData], Tuple[TrainState, Dict[str, Any]]]:
    """One optimizer step on the state's model and optimizer: forward in
    train mode (batch statistics; dropout, DropGraph and stochastic depth
    drawn from the state's generator), loss, backward, clip, update.
    Returns ``(state, {loss, accuracy[, grad_norms]})``; the state is
    updated in place and the metrics are device tensors.

    ``grad_norms``: per-parameter L2 norms of the raw gradients (before
    clipping), keyed by state_dict name.

    ``mesh`` (a data mesh, :mod:`~fall_multimodal_tpu_torch.parallel.mesh`):
    the batch is the global one; it is augmented whole, each rank trains on
    its rows with the whole batch's BatchNorm statistics, and the gradients
    and metrics are averaged across the ranks: the step of one process at
    the global batch.
    """

    def step(state: TrainState, batch: DeviceData):
        model = state.model
        if not model.training:
            model.train()
        feats, sens = batch.features, batch.sensors
        if augment_fn is not None:
            feats, sens = augment_fn(state.generator, feats, sens)
        feats, sens, labels = (local_rows(x, mesh) for x in (feats, sens, batch.labels))
        with full_float32() if compute_dtype is None else contextlib.nullcontext():
            with _precision(compute_dtype, state.device), global_batch_stats(model, mesh):
                logits = model(feats, sens, generator=state.generator)
            loss = cross_entropy(logits.float(), labels,
                                 label_smoothing=label_smoothing,
                                 softmax_before_ce=softmax_before_ce)
            state.optimizer.zero_grad()
            loss.backward()
            if mesh is not None:
                grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                         for p in state.optimizer.params]
                for p, g in zip(state.optimizer.params, grads):
                    p.grad = g
                all_reduce_(grads, mesh, average=True)
            metrics: Dict[str, Any] = {}
            if grad_norms:
                from fall_multimodal_tpu_torch.utils.profiling import grad_norms as _gn

                metrics["grad_norms"] = _gn(model)
            state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels.argmax(-1)).float().mean()
            loss = loss.detach()
            if mesh is not None:
                scalars = torch.stack([loss, acc])
                all_reduce_([scalars], mesh, average=True)
                loss, acc = scalars
        metrics.update(loss=loss, accuracy=acc)
        return state, metrics

    return step


def make_train_epoch(label_smoothing=0.0, softmax_before_ce=False, compute_dtype=None,
                     grad_norms=False, impl: str = "auto", augment_fn=None,
                     mesh: Optional[Mesh] = None):
    """Whole-epoch function: ``(state, data, batch_idx) -> (state, metrics)``
    over an explicit ``(steps, batch)`` index matrix (numpy or a tensor).

    ``metrics`` holds the epoch means of loss and accuracy as device
    scalars; with ``grad_norms=True`` also a ``"grad_norms"`` dict of
    per-parameter ``(steps,)`` tensors, read by the caller once per epoch.

    ``impl``: ``"auto"`` and ``"host"`` drive the step from Python (the JAX
    package's ``"host"``). ``"scan"`` has no counterpart in the port yet.
    ``mesh``: every rank steps through the same global index matrix
    (:func:`make_train_step`).
    """
    if impl not in ("auto", "host"):
        raise ValueError(
            f"epoch impl {impl!r} is not available in the PyTorch port: it drives "
            "every step from the host ('host'; 'auto' picks it); a whole epoch "
            "as one device program ('scan') has no counterpart yet")
    train_step = make_train_step(label_smoothing, softmax_before_ce, compute_dtype,
                                 grad_norms=grad_norms, augment_fn=augment_fn, mesh=mesh)

    def epoch(state: TrainState, data: DeviceData, batch_idx):
        batch_idx = torch.as_tensor(batch_idx, device=data.features.device)
        steps = batch_idx.shape[0]
        if steps == 0:
            # a zero-step epoch (train n < batch_size with drop_last) degrades
            # to NaN metrics so the fit() NaN guard names it
            nan = torch.full((), float("nan"))
            return state, {"loss": nan, "accuracy": nan}
        losses, accs, norms = [], [], []
        for i in range(steps):
            _, m = train_step(state, gather_batch(data, batch_idx[i]))
            losses.append(m["loss"])
            accs.append(m["accuracy"])
            if grad_norms:
                norms.append(m["grad_norms"])
        out: Dict[str, Any] = {"loss": torch.stack(losses).mean(),
                               "accuracy": torch.stack(accs).mean()}
        if grad_norms:
            out["grad_norms"] = {k: torch.stack([n[k] for n in norms]) for k in norms[0]}
        return state, out

    return epoch


def make_eval_epoch(num_classes: int, label_smoothing=0.0, softmax_before_ce=False,
                    mesh: Optional[Mesh] = None):
    """Eval over padded batches: ``(state, data, batch_idx, batch_mask) ->
    (confusion (K, K), loss_sum)``, both accumulated on the device under
    the mask. The model runs in eval mode (running statistics), full
    float32, without autograd. ``mesh``: each rank evaluates its rows of
    every batch, and the two sums are summed across the ranks."""

    def epoch(state: TrainState, data: DeviceData, batch_idx, batch_mask):
        dev = data.features.device
        batch_idx = torch.as_tensor(batch_idx, device=dev)
        batch_mask = torch.as_tensor(batch_mask, device=dev, dtype=torch.float32)
        model = state.model
        was_training = model.training
        model.eval()
        cm = torch.zeros(num_classes * num_classes, device=dev)
        loss_sum = torch.zeros((), device=dev)
        try:
            with torch.no_grad(), full_float32():
                for idx, mask in zip(batch_idx, batch_mask):
                    idx, mask = local_rows(idx, mesh), local_rows(mask, mesh)
                    batch = gather_batch(data, idx)
                    logits = model(batch.features, batch.sensors)
                    flat = batch.labels.argmax(-1) * num_classes + logits.argmax(-1)
                    cm += torch.bincount(flat, weights=mask, minlength=num_classes ** 2)
                    per_sample = cross_entropy_per_sample(
                        logits, batch.labels, label_smoothing, softmax_before_ce)
                    loss_sum += (per_sample * mask).sum()
        finally:
            model.train(was_training)
        all_reduce_([cm, loss_sum], mesh)
        return cm.reshape(num_classes, num_classes), loss_sum

    return epoch


def evaluate(eval_epoch, state: TrainState, data: DeviceData, batch_size: int) -> EvalResult:
    """One eval epoch with one device->host read."""
    if data.n == 0:
        raise ValueError(EMPTY_SPLIT)
    cm, loss_sum = eval_epoch(state, data, eval_batch_indices(data.n, batch_size),
                              eval_batch_mask(data.n, batch_size))
    host = torch.cat([cm.flatten(), loss_sum[None]]).cpu().numpy()
    cm = host[:-1].reshape(cm.shape)
    stats = {k: v.numpy() for k, v in prf_from_confusion(cm).items()}
    return EvalResult(loss=float(host[-1]) / data.n, accuracy=float(stats["accuracy"]),
                      confusion=cm, stats=stats)


class FitResult(NamedTuple):
    state: TrainState
    best_state: TrainState
    best_val_accuracy: float
    history: Dict[str, list]
    test: Optional[EvalResult]


def epoch_seed(shuffle_seed: int, epoch: int) -> int:
    """The generator's seed for one epoch: the shuffle, the augmentation and
    the model's train-mode draws of epoch ``epoch`` depend on nothing else,
    so a resumed run repeats them (the JAX package folds the epoch into its
    shuffle key)."""
    return (int(shuffle_seed) * 1_000_003 + int(epoch)) % (2 ** 63)


def fit(
    state: TrainState,
    splits: Dict[str, DeviceData],
    epochs: int,
    batch_size: int,
    num_classes: int,
    label_smoothing: float = 0.0,
    softmax_before_ce: bool = False,
    drop_last: bool = True,
    shuffle_seed: int = 0,
    logger=None,
    log_every: int = 10,
    checkpointer=None,
    compute_dtype: Optional[torch.dtype] = None,
    metrics_callback=None,
    start_epoch: int = 1,
    initial_best_acc: float = -1.0,
    initial_best_state: Optional[TrainState] = None,
    nan_guard: bool = True,
    grad_norms: bool = False,
    step_metrics_callback=None,
    lr_fn=None,
    epoch_impl: str = "auto",
    augment_fn=None,
    scan_epochs=None,
    mesh: Optional[Mesh] = None,
) -> FitResult:
    """Epoch driver: train -> valid (track best) -> final test on best.

    Capability of the reference ``run()`` (``main.py:253-348``):
    best-model tracking on validation accuracy, resumable state
    (``start_epoch``, ``initial_best_acc``, ``initial_best_state``), final
    test on the best state. The best state is a snapshot
    (:meth:`TrainState.snapshot`) taken when validation accuracy improves
    on an epoch whose train loss is finite; later steps do not move it. With
    ``nan_guard`` a non-finite train loss stops the run and keeps the best
    state. ``step_metrics_callback`` receives per-step gradient norms
    (``grad_norms=True``), flushed once per epoch.

    ``mesh``: a data mesh (:func:`~fall_multimodal_tpu_torch.parallel.mesh.
    make_mesh`) turns the run data-parallel: rank 0's state and splits on
    every rank, each step's global batch split across the ranks
    (:func:`make_train_step`), eval sums across them; the curves are the
    single process's at the same global batch. Only rank 0 logs, calls
    back and writes checkpoints; the log line adds windows/s in all and per
    card (:class:`~fall_multimodal_tpu_torch.utils.profiling.Throughput`).
    """
    if scan_epochs:
        raise ValueError(
            "scan_epochs fuses the whole run into one device program; the "
            "PyTorch port drives every step from the host and has no "
            "counterpart yet (leave train.scan_epochs unset)")
    if splits["valid"].n == 0:
        raise ValueError(EMPTY_SPLIT)
    throughput = None
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"batch_size={batch_size} must divide evenly over the "
                             f"{mesh.size}-process mesh")
        state = replicate_state(state, mesh)
        if initial_best_state is not None:
            initial_best_state = replicate_state(initial_best_state, mesh)
        splits = {k: replicate_data(v, mesh) for k, v in splits.items()}
        if mesh.rank != 0:
            logger = checkpointer = metrics_callback = step_metrics_callback = None
        throughput = Throughput(n_devices=mesh.size)
    train_epoch = make_train_epoch(label_smoothing, softmax_before_ce, compute_dtype,
                                   grad_norms=grad_norms, impl=epoch_impl,
                                   augment_fn=augment_fn, mesh=mesh)
    eval_epoch = make_eval_epoch(num_classes, label_smoothing, softmax_before_ce, mesh=mesh)

    history: Dict[str, list] = {
        "train_loss": [], "train_acc": [], "val_loss": [], "val_acc": [],
        "epoch_time": [],
    }
    # on resume the caller passes the restored *best* state: seeding it with
    # the restored latest weights would test non-best weights if no epoch
    # after the resume improves (the reference reloads best, main.py:344)
    best_state = initial_best_state if initial_best_state is not None else state.snapshot()
    best_acc = initial_best_acc

    for epoch_i in range(start_epoch, epochs + 1):
        t0 = time.perf_counter()
        state.generator.manual_seed(epoch_seed(shuffle_seed, epoch_i))
        idx = epoch_batch_indices(state.generator, splits["train"].n, batch_size, drop_last)
        state, tm = train_epoch(state, splits["train"], idx)
        val = evaluate(eval_epoch, state, splits["valid"], batch_size)

        per_step_norms = tm.pop("grad_norms", None)
        scalars = torch.stack([tm["loss"].float(), tm["accuracy"].float()]).cpu().tolist()
        train_loss, train_acc = scalars
        dt = time.perf_counter() - t0
        if per_step_norms is not None and step_metrics_callback is not None:
            host = {k: v.cpu().numpy() for k, v in per_step_norms.items()}
            steps_this_epoch = len(next(iter(host.values())))
            # global step numbers anchored at epoch 1, so a resumed run does
            # not re-emit the first run's steps
            base = (epoch_i - 1) * steps_this_epoch
            for i in range(steps_this_epoch):
                step_metrics_callback(
                    base + i, {f"grad_norm/{k}": float(v[i]) for k, v in host.items()})

        if nan_guard and not np.isfinite(train_loss):
            if logger:
                logger.error(f"non-finite train loss at epoch {epoch_i}; stopping and "
                             f"keeping the best state (val acc {best_acc:.4f})")
            history["train_loss"].append(train_loss)
            break
        history["train_loss"].append(train_loss)
        history["train_acc"].append(train_acc)
        history["val_loss"].append(val.loss)
        history["val_acc"].append(val.accuracy)
        history["epoch_time"].append(dt)

        if val.accuracy > best_acc and np.isfinite(train_loss):
            best_acc, best_state = val.accuracy, state.snapshot()
            if checkpointer is not None:
                checkpointer.save_best(state, epoch_i, best_acc)

        if metrics_callback is not None:
            epoch_scalars = {
                "train_loss": train_loss,
                "train_accuracy": train_acc,
                "val_loss": val.loss,
                "val_accuracy": val.accuracy,
            }
            if lr_fn is not None:
                epoch_scalars["lr"] = float(lr_fn(state.step - 1))
            metrics_callback(epoch_i, epoch_scalars)
        rate = ""
        if throughput is not None:
            throughput.update(idx.numel())
            rate = (f" | {throughput.windows_per_sec:.1f} windows/s, "
                    f"{throughput.windows_per_sec_per_chip:.1f} per card")
        if logger and (epoch_i % log_every == 0 or epoch_i == epochs):
            logger.info(
                f"epoch {epoch_i}/{epochs} "
                f"train loss {train_loss:.4f} acc {train_acc:.4f} | "
                f"val loss {val.loss:.4f} acc {val.accuracy:.4f} | {dt:.2f}s{rate}")
        if checkpointer is not None:
            checkpointer.save_latest(state, epoch_i, best_acc)

    test = None
    if "test" in splits and splits["test"].n > 0:
        test = evaluate(eval_epoch, best_state, splits["test"], batch_size)
    return FitResult(state=state, best_state=best_state, best_val_accuracy=best_acc,
                     history=history, test=test)


def k_copies_logits(forward, skeleton: torch.Tensor, sensor: Optional[torch.Tensor],
                    num_copies: int = 2) -> torch.Tensor:
    """Strided-segment inference average (``Multimodal_Fall3/main.py:150-161``;
    JAX ``train/loop.py:631-653``): the window is cut into ``num_copies``
    contiguous time slices, ``forward(slice, sensor)`` runs on each (a
    contiguous copy: the kernels take no strided input) and the logits are
    averaged. T is axis 1. ``num_copies`` must lie in [1, T]; when it does
    not divide T, the last T % num_copies frames are dropped, as the
    reference's integer stride does. The sensor window is passed whole."""
    t_len = skeleton.shape[1]
    if not 1 <= num_copies <= t_len:
        raise ValueError(f"num_copies={num_copies} must be between 1 and the window length "
                         f"T={t_len} (stride = T // num_copies would be 0)")
    stride = t_len // num_copies
    outs = [forward(skeleton[:, j * stride:(j + 1) * stride].contiguous(), sensor)
            for j in range(num_copies)]
    return torch.stack(outs, dim=1).mean(dim=1)
