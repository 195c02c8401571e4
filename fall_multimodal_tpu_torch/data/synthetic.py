"""Synthetic multimodal fall-detection data.

Generates class-separable skeleton + sensor windows with the exact shapes and
value conventions of the real pipelines (HAR-UP: ``(N,30,14,3)`` pose in
[-1,1] with confidence channel, ``(N,30,15)`` accelerometers, soft labels;
UR-Fall: sensor dim 4, 2 classes). Used by tests (overfit-one-batch), the
benchmark harness, and as a stand-in when the real CSV/pickle datasets are
not mounted. Each class gets a distinct joint-motion signature so models can
actually learn; samples are grouped into pseudo-videos so video-level splits
are exercised.

The PyTorch port's own copy of the JAX package's ``data/synthetic.py``
(numpy only, unchanged): the same seed gives the same arrays byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class WindowedDataset:
    """Host-side windowed dataset: the unit every loader returns.

    ``features``: (N, T, V, C) skeleton windows, channel-last TPU layout;
    ``sensors``: (N, T, S) or None; ``labels``: (N, K) soft rows;
    ``videos``: (N,) video name per window (split unit).
    """

    features: np.ndarray
    labels: np.ndarray
    sensors: Optional[np.ndarray] = None
    videos: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.videos is None:
            self.videos = np.arange(len(self.features))

    def __len__(self) -> int:
        return len(self.features)

    @property
    def num_classes(self) -> int:
        return self.labels.shape[-1]

    def subset(self, idx: np.ndarray) -> "WindowedDataset":
        return WindowedDataset(
            features=self.features[idx],
            labels=self.labels[idx],
            sensors=None if self.sensors is None else self.sensors[idx],
            videos=self.videos[idx],
        )


def make_synthetic(
    n_windows: int = 512,
    seq_len: int = 30,
    num_joints: int = 14,
    num_classes: int = 11,
    sensor_dim: int = 15,
    windows_per_video: int = 16,
    noise: float = 0.15,
    soft_labels: bool = True,
    seed: int = 0,
) -> WindowedDataset:
    rng = np.random.default_rng(seed)
    labels_idx = rng.integers(0, num_classes, size=n_windows)

    # Class signature: a per-class joint trajectory basis. Pose = signature
    # sinusoid (class-dependent frequency/phase per joint) + noise.
    t = np.linspace(0, 1, seq_len)[None, :, None]  # (1,T,1)
    freqs = 1.0 + rng.random((num_classes, num_joints)) * 4.0
    phases = rng.random((num_classes, num_joints)) * 2 * np.pi
    amps = 0.3 + rng.random((num_classes, num_joints)) * 0.7

    f = freqs[labels_idx][:, None, :]   # (N,1,V)
    p = phases[labels_idx][:, None, :]
    a = amps[labels_idx][:, None, :]
    x = a * np.sin(2 * np.pi * f * t + p)
    y = a * np.cos(2 * np.pi * f * t + p)
    score = np.clip(0.7 + 0.3 * rng.random((n_windows, seq_len, num_joints)), 0, 1)
    pose = np.stack([x, y, score], axis=-1).astype(np.float32)
    pose[..., :2] += noise * rng.standard_normal((n_windows, seq_len, num_joints, 2))
    pose[..., :2] = np.clip(pose[..., :2], -1, 1)

    sensors = None
    if sensor_dim:
        sf = 1.0 + rng.random((num_classes, sensor_dim)) * 6.0
        sp = rng.random((num_classes, sensor_dim)) * 2 * np.pi
        sensors = np.sin(
            2 * np.pi * sf[labels_idx][:, None, :] * t + sp[labels_idx][:, None, :]
        ).astype(np.float32)
        sensors += noise * rng.standard_normal(sensors.shape).astype(np.float32)

    onehot = np.eye(num_classes, dtype=np.float32)[labels_idx]
    if soft_labels:
        # score-weighted soft labels as the real prep produces
        onehot = onehot * (0.85 + 0.15 * rng.random((n_windows, 1))).astype(np.float32)

    videos = np.asarray(
        [f"video_{i // windows_per_video:04d}" for i in range(n_windows)]
    )
    return WindowedDataset(
        features=pose, labels=onehot, sensors=sensors, videos=videos
    )
