"""Device-resident batching (counterpart of the JAX package's
``data/pipeline.py:22-92``).

Every split fits in the card's memory for every workload this framework
targets, so the pipeline is one copy per split to the device, then every
epoch is a fresh permutation drawn on the device and reshaped to a
``(steps, batch)`` index matrix that the train step gathers from. No
per-batch host->device copies, no worker processes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fall_multimodal_tpu_torch.data.synthetic import WindowedDataset


class DeviceData(NamedTuple):
    """A split resident on the device. ``sensors`` is all-zeros ``(N, 1, 1)``
    when the dataset has no sensor stream, so every split has three tensors."""

    features: torch.Tensor  # (N, T, V, C)
    labels: torch.Tensor    # (N, K)
    sensors: torch.Tensor   # (N, T, S) or (N, 1, 1) placeholder

    @property
    def n(self) -> int:
        return self.features.shape[0]


def to_device(data: WindowedDataset, device="cuda",
              dtype: torch.dtype = torch.float32) -> DeviceData:
    """Copy a host split to ``device`` (the card unless the caller says
    otherwise; :func:`~fall_multimodal_tpu_torch.utils.device.resolve_device`
    refuses a card that is not there)."""
    from fall_multimodal_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    sensors = (
        data.sensors
        if data.sensors is not None
        else np.zeros((len(data), 1, 1), np.float32)
    )

    def put(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(dev)

    return DeviceData(
        features=put(data.features, dtype),
        labels=put(data.labels, torch.float32),
        sensors=put(sensors, dtype),
    )


def epoch_batch_indices(generator: torch.Generator, n: int, batch_size: int,
                        drop_last: bool = True) -> torch.Tensor:
    """(steps, batch_size) shuffled index matrix for one epoch, drawn by
    ``torch.randperm`` on the generator's device.

    With ``drop_last=False`` the tail batch is padded by wrapping around the
    permutation (duplicates only in the final batch of an epoch; a split
    smaller than half a batch wraps more than once, where the JAX package's
    concatenation would fail).
    """
    perm = torch.randperm(n, generator=generator, device=generator.device)
    if drop_last:
        steps = n // batch_size
        return perm[: steps * batch_size].reshape(steps, batch_size)
    steps = -(-n // batch_size)
    wrap = torch.arange(steps * batch_size, device=perm.device) % n
    return perm[wrap].reshape(steps, batch_size)


def eval_batch_indices(n: int, batch_size: int) -> np.ndarray:
    """Deterministic eval batching; tail padded by repeating the last index.

    Metrics mask the padding via :func:`eval_batch_mask`.
    """
    steps = -(-n // batch_size)
    idx = np.arange(steps * batch_size)
    idx = np.minimum(idx, n - 1)
    return idx.reshape(steps, batch_size)


def eval_batch_mask(n: int, batch_size: int) -> np.ndarray:
    steps = -(-n // batch_size)
    return (np.arange(steps * batch_size) < n).reshape(steps, batch_size)


def gather_batch(data: DeviceData, idx: torch.Tensor) -> DeviceData:
    """One batch by index, gathered on the device."""
    return DeviceData(
        features=data.features.index_select(0, idx),
        labels=data.labels.index_select(0, idx),
        sensors=data.sensors.index_select(0, idx),
    )
