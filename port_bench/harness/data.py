"""The benchmark's inputs, made from the seed on the host: synthetic pose and
sensor windows and the split of a training set by video.

The window generator is a copy of the synthetic generator the system ships
(class-dependent joint sinusoids plus noise, pose in [-1, 1] with a
confidence channel, soft labels, windows grouped into pseudo-videos), so
that the benchmark's traffic does not move when the system's copy does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np


class Windows(NamedTuple):
    pose: np.ndarray                 # (N, T, V, 3) float32
    sensor: Optional[np.ndarray]     # (N, T, S) float32, or None
    labels: np.ndarray               # (N, K) float32 soft rows
    videos: np.ndarray               # (N,) video name per window


def make_windows(n: int, seq_len: int, num_joints: int, num_classes: int, sensor_dim: int,
                 noise: float, seed: int, windows_per_video: int = 16) -> Windows:
    rng = np.random.default_rng(seed)
    labels_idx = rng.integers(0, num_classes, size=n)
    t = np.linspace(0, 1, seq_len)[None, :, None]
    freqs = 1.0 + rng.random((num_classes, num_joints)) * 4.0
    phases = rng.random((num_classes, num_joints)) * 2 * np.pi
    amps = 0.3 + rng.random((num_classes, num_joints)) * 0.7
    f, p, a = (x[labels_idx][:, None, :] for x in (freqs, phases, amps))
    x = a * np.sin(2 * np.pi * f * t + p)
    y = a * np.cos(2 * np.pi * f * t + p)
    score = np.clip(0.7 + 0.3 * rng.random((n, seq_len, num_joints)), 0, 1)
    pose = np.stack([x, y, score], axis=-1).astype(np.float32)
    pose[..., :2] += noise * rng.standard_normal((n, seq_len, num_joints, 2))
    pose[..., :2] = np.clip(pose[..., :2], -1, 1)
    sensor = None
    if sensor_dim:
        sf = 1.0 + rng.random((num_classes, sensor_dim)) * 6.0
        sp = rng.random((num_classes, sensor_dim)) * 2 * np.pi
        sensor = np.sin(2 * np.pi * sf[labels_idx][:, None, :] * t
                        + sp[labels_idx][:, None, :]).astype(np.float32)
        sensor += noise * rng.standard_normal(sensor.shape).astype(np.float32)
    onehot = np.eye(num_classes, dtype=np.float32)[labels_idx]
    onehot = onehot * (0.85 + 0.15 * rng.random((n, 1))).astype(np.float32)
    videos = np.asarray([f"video_{i // windows_per_video:04d}" for i in range(n)])
    return Windows(pose, sensor, onehot, videos)


def split_by_video(videos: np.ndarray, fractions: Tuple[float, float, float],
                   seed: int) -> Dict[str, np.ndarray]:
    """Window indices of train / valid / test: whole videos, shuffled by the
    seed, cut by the fractions of the video count (rounded)."""
    units = np.unique(videos)
    perm = np.random.default_rng(seed).permutation(len(units))
    n_train = int(round(fractions[0] * len(units)))
    n_valid = int(round(fractions[1] * len(units)))
    groups = {"train": perm[:n_train], "valid": perm[n_train:n_train + n_valid],
              "test": perm[n_train + n_valid:]}
    return {k: np.where(np.isin(videos, units[g]))[0] for k, g in groups.items()}
