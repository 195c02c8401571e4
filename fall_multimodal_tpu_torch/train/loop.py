"""Training / evaluation engine (counterpart of the JAX package's
``train/loop.py:50-628``).

The JAX package runs an epoch as one jitted ``lax.scan`` on the TPU
(``epoch_impl="scan"``) or drives the same jitted step from a Python loop
(``"host"``), and with ``scan_epochs`` fuses a whole run (every epoch's
shuffle, train scan, eval and best-state gate) into one device program with
one host round trip per chunk of epochs. PyTorch runs eagerly, so on this
card every epoch impl is a Python loop that launches each step from the
host: the batch is gathered on the device from a ``(steps, batch)`` index
matrix and the metrics stay on the device. The fused driver keeps the JAX
package's semantics (:class:`FusedEpochs`): nothing is read back inside a
chunk, the best state is gated on the device, and the NaN guard is applied
after the chunk's one read.

Float32 means float32: with ``compute_dtype=None`` a train step and an eval
epoch run with cuDNN's and cuBLAS's TF32 switches off and the caller's
switches restored after (:func:`~fall_multimodal_tpu_torch.utils.device.
full_float32`). ``compute_dtype=torch.bfloat16`` runs the forward under
``torch.autocast`` with float32 master weights and a float32 loss.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

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


EPOCH_IMPLS = ("auto", "scan", "host")


def resolve_epoch_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` is ``"scan"`` on the card and ``"host"`` on the CPU, as the
    JAX package picks by backend."""
    if impl not in EPOCH_IMPLS:
        raise ValueError(f"epoch impl must be scan|host|auto, got {impl!r}")
    if impl == "auto":
        return "host" if torch.device(device).type == "cpu" else "scan"
    return impl


def make_train_epoch(label_smoothing=0.0, softmax_before_ce=False, compute_dtype=None,
                     grad_norms=False, impl: str = "auto", augment_fn=None,
                     mesh: Optional[Mesh] = None):
    """Whole-epoch function: ``(state, data, batch_idx) -> (state, metrics)``
    over an explicit ``(steps, batch)`` index matrix (numpy or a tensor).

    ``metrics`` holds the epoch means of loss and accuracy as device
    scalars; with ``grad_norms=True`` also a ``"grad_norms"`` dict of
    per-parameter ``(steps,)`` tensors. Nothing is read back to the host.

    ``impl``: ``"scan"``, ``"host"`` or ``"auto"`` (:func:`resolve_epoch_impl`).
    The JAX package's ``"scan"`` is one device program per epoch; on this
    card every impl is the same Python loop of steps, each launched from the
    host, with each step's metrics written into ``(steps,)`` device buffers
    (the scan's stacked outputs). The name decides only whether
    :func:`fit` fuses epochs by default.
    ``mesh``: every rank steps through the same global index matrix
    (:func:`make_train_step`).
    """
    if impl not in EPOCH_IMPLS:
        raise ValueError(f"epoch impl must be scan|host|auto, got {impl!r}")
    train_step = make_train_step(label_smoothing, softmax_before_ce, compute_dtype,
                                 grad_norms=grad_norms, augment_fn=augment_fn, mesh=mesh)

    def epoch(state: TrainState, data: DeviceData, batch_idx):
        dev = data.features.device
        batch_idx = torch.as_tensor(batch_idx, device=dev)
        steps = batch_idx.shape[0]
        if steps == 0:
            # a zero-step epoch (train n < batch_size with drop_last) degrades
            # to NaN metrics so the fit() NaN guard names it
            nan = torch.full((), float("nan"), device=dev)
            return state, {"loss": nan, "accuracy": nan}
        losses = torch.empty(steps, device=dev)
        accs = torch.empty(steps, device=dev)
        norms: Dict[str, torch.Tensor] = {}
        for i in range(steps):
            _, m = train_step(state, gather_batch(data, batch_idx[i]))
            losses[i] = m["loss"]
            accs[i] = m["accuracy"]
            for name, v in m.get("grad_norms", {}).items():
                norms.setdefault(name, torch.empty(steps, device=dev))[i] = v
        out: Dict[str, Any] = {"loss": losses.mean(), "accuracy": accs.mean()}
        if grad_norms:
            out["grad_norms"] = norms
        return state, out

    return epoch


def make_eval_epoch(num_classes: int, label_smoothing=0.0, softmax_before_ce=False,
                    mesh: Optional[Mesh] = None):
    """Eval over padded batches: ``(state, data, batch_idx, batch_mask) ->
    (confusion (K, K), loss_sum)``, both accumulated on the device under
    the mask, with no read back to the host. The model runs in eval mode (running statistics), full
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
                    # not bincount: on the card it reads its input's maximum
                    # back to the host; the 0/1 mask keeps the counts exact
                    cm.index_add_(0, flat, mask)
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


def equal_chunk(n: int, chunk: int) -> int:
    """Largest chunk size <= ``chunk`` that divides ``n`` exactly (JAX
    ``loop.py:301``): every chunk of a fused run is the same length, e.g.
    100 epochs with a requested chunk of 33 run as 4 chunks of 25."""
    if n <= 0:
        return max(1, chunk)
    chunk = max(1, min(chunk, n))
    while n % chunk:
        chunk -= 1
    return chunk


def _optimizer_entries(optimizer):
    """``(parameter index, key, value)`` of the torch optimizer's state."""
    for i, p in enumerate(optimizer.params):
        for key, value in optimizer.inner.state.get(p, {}).items():
            yield i, key, value


class _HostFields(NamedTuple):
    """What a train state keeps outside its device tensors, recorded after
    each fused epoch so that the best epoch's can be restored with no read
    from the device: the step counters, the generator's state, the learning
    rates of the param groups, which optimizer-state entries exist, and the
    entries that do not live on the state's device (torch's ``step``
    counters of RMSprop and Adam are CPU tensors)."""

    step: int
    gradient_step: int
    mini_step: int
    generator: torch.Tensor
    groups: List[dict]
    entries: frozenset
    off_device: Dict[Tuple[int, str], Any]

    @classmethod
    def of(cls, state: TrainState) -> "_HostFields":
        opt = state.optimizer
        on = state.device.type
        entries, off = set(), {}
        for i, key, value in _optimizer_entries(opt):
            entries.add((i, key))
            if not (torch.is_tensor(value) and value.device.type == on):
                off[(i, key)] = copy.deepcopy(value)
        groups = [copy.deepcopy({k: v for k, v in g.items() if k != "params"})
                  for g in opt.inner.param_groups]
        return cls(state.step, opt.gradient_step, opt.mini_step, state.generator.get_state(),
                   groups, frozenset(entries), off)

    def restore(self, state: TrainState) -> TrainState:
        opt = state.optimizer
        state.step, opt.gradient_step, opt.mini_step = (self.step, self.gradient_step,
                                                         self.mini_step)
        state.generator.set_state(self.generator)
        for group, saved in zip(opt.inner.param_groups, self.groups):
            group.update(saved)
        for i, p in enumerate(opt.params):
            st = opt.inner.state.get(p)
            if st is None:
                continue
            for key in [k for k in st if (i, k) not in self.entries]:
                del st[key]
            if not st:
                del opt.inner.state[p]
        for (i, key), value in self.off_device.items():
            opt.inner.state[opt.params[i]][key] = value
        return state


def _device_pairs(best: TrainState, live: TrainState) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(best, live)`` pairs of every tensor a train state keeps on its
    device: weights, buffers, the optimizer's state and accumulators. An
    optimizer-state entry that ``live`` made after ``best`` was copied is
    allocated in ``best`` (once); :class:`_HostFields` drops it again if the
    best epoch had none."""
    live_sd, best_sd = live.model.state_dict(), best.model.state_dict()
    pairs = [(best_sd[k], v) for k, v in live_sd.items()]
    on = live.device.type
    for i, key, value in _optimizer_entries(live.optimizer):
        if torch.is_tensor(value) and value.device.type == on:
            st = best.optimizer.inner.state[best.optimizer.params[i]]
            if key not in st:
                st[key] = value.clone()
            pairs.append((st[key], value))
    if live.optimizer.acc is not None:
        pairs.extend(zip(best.optimizer.acc, live.optimizer.acc))
    return pairs


class FusedEpochs:
    """The fused epoch driver (counterpart of JAX ``loop.py:437-551``): runs
    chunks of epochs, each epoch reseeded (:func:`epoch_seed`), shuffled,
    trained and evaluated on the device, with nothing read back inside a
    chunk. The best state is gated on the device: after each epoch,
    ``improved = (val_acc > best) & isfinite(train_loss)`` selects with
    ``torch.where`` between the live state and one copy of it (allocated at
    the first epoch, then written in place), and the best accuracy moves the
    same way in float64, so ties resolve as :func:`fit`'s per-epoch
    comparison of the same float32 accuracy. The host fields of every epoch
    are recorded (:class:`_HostFields`); :meth:`best_state` restores those of
    the best epoch, which the caller learns from the chunk's curves."""

    def __init__(self, state: TrainState, splits: Dict[str, DeviceData], train_epoch,
                 eval_epoch, batch_size: int, drop_last: bool, shuffle_seed: int,
                 best_acc: float):
        valid = splits["valid"]
        if valid.n == 0:
            raise ValueError(EMPTY_SPLIT)
        dev = valid.features.device
        self.state, self.train, self.valid = state, splits["train"], valid
        self.train_epoch, self.eval_epoch = train_epoch, eval_epoch
        self.batch_size, self.drop_last, self.shuffle_seed = batch_size, drop_last, shuffle_seed
        self.vidx = torch.as_tensor(eval_batch_indices(valid.n, batch_size), device=dev)
        self.vmask = torch.as_tensor(eval_batch_mask(valid.n, batch_size), device=dev,
                                     dtype=torch.float32)
        self.best_acc = torch.tensor(float(best_acc), dtype=torch.float64, device=dev)
        self.best: Optional[TrainState] = None
        self.records: List[_HostFields] = []

    @torch.no_grad()
    def _gate(self, improved: torch.Tensor) -> None:
        if self.best is None:
            self.best = self.state.snapshot()
            return
        for best, live in _device_pairs(self.best, self.state):
            torch.where(improved, live, best, out=best)

    def chunk(self, epochs: Sequence[int]) -> torch.Tensor:
        """Runs the epochs numbered ``epochs`` and returns their curves, unread:
        a ``(len(epochs), 5)`` device tensor of train loss, train accuracy,
        validation loss sum, validation accuracy and ``improved`` (0/1)."""
        rows = []
        for epoch_i in epochs:
            state = self.state
            state.generator.manual_seed(epoch_seed(self.shuffle_seed, epoch_i))
            idx = epoch_batch_indices(state.generator, self.train.n, self.batch_size,
                                      self.drop_last)
            state, tm = self.train_epoch(state, self.train, idx)
            cm, loss_sum = self.eval_epoch(state, self.valid, self.vidx, self.vmask)
            acc = prf_from_confusion(cm)["accuracy"]
            improved = (acc.double() > self.best_acc) & torch.isfinite(tm["loss"])
            self._gate(improved)
            torch.where(improved, acc.double(), self.best_acc, out=self.best_acc)
            self.records.append(_HostFields.of(state))
            rows.append(torch.stack([tm["loss"].float(), tm["accuracy"].float(),
                                     loss_sum.float(), acc, improved.float()]))
        return torch.stack(rows)

    def best_state(self, run_index: int) -> TrainState:
        """The gated copy with the host fields of the ``run_index``-th epoch
        run, the last one whose ``improved`` was set."""
        return self.records[run_index].restore(self.best)


def _fit_fused(fused: FusedEpochs, epochs: int, start_epoch: int, scan_epochs,
               best_state: TrainState, best_acc: float, nan_guard: bool, logger,
               log_every: int, history: Dict[str, list]) -> Tuple[TrainState, float]:
    """:func:`fit`'s fused run: chunks of :func:`equal_chunk` epochs, one
    host read each; then the history, the post-hoc NaN guard and the log
    lines as the JAX package writes them (``loop.py:490-551``)."""
    n_epochs = max(0, epochs - start_epoch + 1)
    chunk = equal_chunk(n_epochs, n_epochs if scan_epochs is True else max(1, int(scan_epochs)))
    rows: List[np.ndarray] = []
    times: List[float] = []
    for s in range(0, n_epochs, chunk):
        t0 = time.perf_counter()
        host = fused.chunk(range(start_epoch + s, start_epoch + s + chunk)).cpu().numpy()
        times += [(time.perf_counter() - t0) / len(host)] * len(host)
        rows.extend(host)
    improved = [i for i, row in enumerate(rows) if row[4]]
    if improved:
        best_acc = float(rows[improved[-1]][3])
        best_state = fused.best_state(improved[-1])
    n = fused.valid.n
    history["train_loss"] = [float(r[0]) for r in rows]
    history["train_acc"] = [float(r[1]) for r in rows]
    history["val_loss"] = [float(r[2]) / n for r in rows]
    history["val_acc"] = [float(r[3]) for r in rows]
    history["epoch_time"] = times
    bad = [i for i, r in enumerate(rows) if not np.isfinite(r[0])]
    if nan_guard and bad:
        # the per-epoch guard's record: train_loss keeps the first non-finite
        # epoch, the other curves end before it; the gate kept the best state
        first = bad[0]
        history["train_loss"] = history["train_loss"][:first + 1]
        for k in ("train_acc", "val_loss", "val_acc", "epoch_time"):
            history[k] = history[k][:first]
        if logger:
            logger.error(f"non-finite train loss at epoch {start_epoch + first}; stopping and "
                         f"keeping the best state (val acc {best_acc:.4f}) "
                         f"[fused epochs: detected after the chunk]")
    elif logger:
        for e in range(len(rows)):
            epoch_i = start_epoch + e
            if epoch_i % log_every == 0 or epoch_i == epochs:
                logger.info(
                    f"epoch {epoch_i}/{epochs} "
                    f"train loss {history['train_loss'][e]:.4f} "
                    f"acc {history['train_acc'][e]:.4f} | "
                    f"val loss {history['val_loss'][e]:.4f} "
                    f"acc {history['val_acc'][e]:.4f} | {times[e]:.2f}s (fused)")
    return best_state, best_acc


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

    ``scan_epochs`` (default: auto, as JAX ``loop.py:415-436``) fuses the
    epochs (:class:`FusedEpochs`): the whole run (``True``) or chunks of
    :func:`equal_chunk` epochs (an int) with one host read each, the best
    state gated on the device, the NaN guard applied after the read (the
    history is cut where the per-epoch loop would have stopped; the epochs
    after it have run). ``None`` turns it on when the resolved epoch impl is
    ``"scan"`` (``epoch_impl="auto"`` on the card) and no checkpointer,
    metrics callback, step-metrics callback or ``grad_norms`` asks for
    per-epoch host work; ``True`` with one of them raises. The curves, the
    best state (every field) and the test metrics are the per-epoch
    loop's. ``history["epoch_time"]`` is a chunk's time over its epochs.

    ``mesh``: a data mesh (:func:`~fall_multimodal_tpu_torch.parallel.mesh.
    make_mesh`) turns the run data-parallel: rank 0's state and splits on
    every rank, each step's global batch split across the ranks
    (:func:`make_train_step`), eval sums across them; the curves are the
    single process's at the same global batch. Only rank 0 logs, calls
    back and writes checkpoints; the per-epoch log line adds windows/s in
    all and per card (:class:`~fall_multimodal_tpu_torch.utils.profiling.
    Throughput`).
    """
    resolved_impl = resolve_epoch_impl(epoch_impl, state.device)
    per_epoch_work = (checkpointer is not None or metrics_callback is not None
                      or step_metrics_callback is not None or grad_norms)
    if scan_epochs is None:
        scan_epochs = resolved_impl == "scan" and not per_epoch_work
    if scan_epochs and (resolved_impl != "scan" or per_epoch_work):
        raise ValueError(
            "scan_epochs=True fuses the epoch loop — it needs the scan epoch impl and "
            "cannot run per-epoch host work (checkpointer / metrics callbacks / "
            "grad-norm streaming)")
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

    if scan_epochs:
        fused = FusedEpochs(state, splits, train_epoch, eval_epoch, batch_size, drop_last,
                            shuffle_seed, best_acc)
        best_state, best_acc = _fit_fused(fused, epochs, start_epoch, scan_epochs, best_state,
                                          best_acc, nan_guard, logger, log_every, history)
        epoch_numbers = range(0)
    else:
        epoch_numbers = range(start_epoch, epochs + 1)
    for epoch_i in epoch_numbers:
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
