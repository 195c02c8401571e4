"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py``), and the fold mesh of the fold-parallel CV
driver.

The JAX package lays a 1-D data mesh over the chips of one program: the
parameters are replicated, every step's batch is split across the chips, and
GSPMD keeps the program's meaning that of one device, BatchNorm's batch
statistics included. Here a data mesh is one process per card in a
``torch.distributed`` group (``torchrun --nproc-per-node N``; NCCL on the
card, gloo on the CPU), with the same meaning as one process at the same
global batch:

* every rank draws the same global index matrix and the same augmentation
  of the whole batch, and trains on its rows ``[r*B/N, (r+1)*B/N)``;
* the port's BatchNorm takes the whole batch's statistics, summed across
  the ranks (:func:`global_batch_stats`), keeping flax's biased running
  variance;
* gradients, train metrics, eval confusion matrices and loss sums are
  summed across the ranks (gradients and metrics then averaged);
* only rank 0 logs, calls back and writes checkpoints (``train/loop.py:fit``).

Draws inside a model (dropout, DropGraph, stochastic depth) are made by each
rank for its own rows, so a family that draws is not the single process's
run; a family that draws nothing (the flagship) is.

A fold mesh (``axis="fold"``) is the devices of one process, one group of
folds each (:func:`~fall_multimodal_tpu_torch.train.cv_vmapped.
cross_validate_vmapped`); it uses no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import TYPE_CHECKING, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from fall_multimodal_tpu_torch.data.pipeline import DeviceData
from fall_multimodal_tpu_torch.utils.device import resolve_device

if TYPE_CHECKING:       # train/loop.py imports this module
    from fall_multimodal_tpu_torch.train.state import TrainState

DATA_AXIS = "data"
FOLD_AXIS = "fold"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh. ``axis="data"``: ``group`` is the ``torch.distributed``
    group of ``size`` processes, and ``devices`` holds this process's
    device. ``axis="fold"``: ``devices`` are this process's devices, one
    shard each, and ``group`` is None."""

    axis: str
    devices: Tuple[torch.device, ...]
    group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return len(self.devices) if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _local_device(dev: torch.device) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev


def initialize_distributed(device="cuda") -> int:
    """Join the process group that ``torchrun`` describes (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``), NCCL on the card and gloo on the CPU, with this process
    on card ``LOCAL_RANK``. Call it once, before anything touches the card.
    Returns the world size."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(_backend(dev), init_method="env://")
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS,
              device="cuda") -> Mesh:
    """A data mesh of ``n_devices`` processes (the world size; one process
    without ``torchrun`` makes a world of 1 in memory), or with
    ``axis="fold"`` a fold mesh of ``n_devices`` devices of this process
    (cards 0..n-1; on the CPU, n shards of the CPU)."""
    dev = resolve_device(device)
    if axis == FOLD_AXIS:
        if dev.type != "cuda":
            return Mesh(axis, (dev,) * (n_devices or 1))
        have = torch.cuda.device_count()
        n = n_devices or have
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        return Mesh(axis, tuple(torch.device("cuda", i) for i in range(n)))
    if axis != DATA_AXIS:
        raise ValueError(f"axis must be {DATA_AXIS!r} or {FOLD_AXIS!r}, got {axis!r}")
    if not dist.is_initialized():
        if (n_devices or 1) != 1:
            raise ValueError(
                f"a data mesh of {n_devices} needs {n_devices} processes: launch with "
                f"torchrun --nproc-per-node {n_devices} and --distributed")
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if (n_devices or world) != world:
        raise ValueError(f"requested a data mesh of {n_devices}, but the process group "
                         f"has {world} processes")
    return Mesh(axis, (_local_device(dev),), dist.group.WORLD)


@contextlib.contextmanager
def global_batch_stats(model: torch.nn.Module, mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block, the model's BatchNorms take the statistics of the
    whole batch across the mesh's ranks (a world of 1 needs none)."""
    from fall_multimodal_tpu_torch.models.layers import BatchNorm1d

    if mesh is None or mesh.size == 1:
        yield
        return
    norms = [m for m in model.modules() if isinstance(m, BatchNorm1d)]
    for m in norms:
        m.stats_group = mesh.group
    try:
        yield
    finally:
        for m in norms:
            del m.stats_group


def local_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows ``[r*B/N, (r+1)*B/N)`` of a global batch."""
    if mesh is None or mesh.size == 1:
        return x
    b = x.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not split evenly over a mesh of {mesh.size}")
    part = b // mesh.size
    return x[mesh.rank * part:(mesh.rank + 1) * part]


def all_reduce_(tensors, mesh: Optional[Mesh], average: bool = False) -> None:
    """Sum (or average) ``tensors`` in place across the mesh's ranks, in one
    collective."""
    if mesh is None or mesh.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    if average:
        flat /= mesh.size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _broadcast_(tensors, mesh: Mesh) -> None:
    if mesh.size == 1:
        return
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's parameters and buffers on every rank (a broadcast)."""
    with torch.no_grad():
        _broadcast_(list(state.model.parameters()) + list(state.model.buffers()), mesh)
    return state


def replicate_data(data: DeviceData, mesh: Mesh) -> DeviceData:
    """Rank 0's split on every rank (a broadcast): every rank gathers its
    batches from the whole split."""
    _broadcast_(list(data), mesh)
    return data


def shard_data(data: DeviceData, mesh: Mesh) -> DeviceData:
    """This rank's contiguous share of a split's samples (for a split too
    large to replicate; each rank then batches its own share)."""
    n = data.n // mesh.size
    return DeviceData(*(t[mesh.rank * n:(mesh.rank + 1) * n] for t in data))


def make_parallel_train_step(mesh: Mesh, label_smoothing: float = 0.0,
                             softmax_before_ce: bool = False, compute_dtype=None,
                             grad_norms: bool = False, augment_fn=None):
    """:func:`~fall_multimodal_tpu_torch.train.loop.make_train_step` over the
    mesh: each rank trains on its rows of the global batch it is given."""
    from fall_multimodal_tpu_torch.train.loop import make_train_step

    return make_train_step(label_smoothing, softmax_before_ce, compute_dtype,
                           grad_norms=grad_norms, augment_fn=augment_fn, mesh=mesh)


def make_parallel_train_epoch(mesh: Mesh, label_smoothing: float = 0.0,
                              softmax_before_ce: bool = False, compute_dtype=None,
                              grad_norms: bool = False, impl: str = "auto",
                              augment_fn=None):
    """:func:`~fall_multimodal_tpu_torch.train.loop.make_train_epoch` over the
    mesh (every capability of the single-device epoch)."""
    from fall_multimodal_tpu_torch.train.loop import make_train_epoch

    return make_train_epoch(label_smoothing, softmax_before_ce, compute_dtype,
                            grad_norms=grad_norms, impl=impl, augment_fn=augment_fn,
                            mesh=mesh)


def make_parallel_eval_epoch(num_classes: int, mesh: Mesh, label_smoothing: float = 0.0,
                             softmax_before_ce: bool = False):
    """:func:`~fall_multimodal_tpu_torch.train.loop.make_eval_epoch` over the
    mesh: each rank evaluates its rows of every batch; the confusion matrix
    and the loss sum are summed across the ranks."""
    from fall_multimodal_tpu_torch.train.loop import make_eval_epoch

    return make_eval_epoch(num_classes, label_smoothing, softmax_before_ce, mesh=mesh)
