"""Feature-pipeline preprocessing, vectorized.

Re-derivation of the reference's offline window/label builder
(``3_stream/har_create4.py:40-127``, ``har_create4_sensor.py``) and the
fetch-time normalization of Gen-3 (``Multimodal_Fall3/dataset.py:27-46``):

* ``scale_pose`` — per-frame min/max normalization of (x, y) to [-1, 1];
* ``add_center_joint`` — 14th joint as the midpoint of joints 1 and 2;
* ``score_weighted_labels`` — per-frame labels scaled by mean keypoint
  confidence with main parts boosted 1.5x;
* ``epsilon_smooth`` / ``seq_label_smoothing`` — label smoothing in time;
* ``segment_continuous`` — split a video at frame-number gaps >= 10;
* ``sliding_windows`` — stride-1 windows of ``seq_len`` frames.

Everything except ``seq_label_smoothing`` (a genuinely sequential,
data-dependent state machine that runs once per video at prep time) is
vectorized numpy; ``scale_pose`` also has a torch twin for tensors already
on the device.

The PyTorch port's own copy of the JAX package's ``data/preprocess.py``: the
numpy functions unchanged, ``scale_pose_jnp`` replaced by
:func:`scale_pose_torch`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# Indices whose confidence scores get boosted before the per-frame mean
# (shoulders, hips, and the synthetic center joint; ``har_create4.py:16``).
MAIN_IDX_PARTS = (1, 2, 7, 8, -1)


def scale_pose(xy: np.ndarray) -> np.ndarray:
    """Min-max normalize each frame's keypoints to [-1, 1] per axis.

    ``xy``: (..., V, 2) — any leading batch/time dims; NaNs are ignored in
    the min/max (reference uses nanmin/nanmax) and preserved in the output
    wherever the axis span is nonzero. Where a frame's axis span is zero the
    reference produces all-NaN (0/0, ``har_create4.py:50``); we emit 0.0 for
    that axis instead so downstream jit code stays finite — intentional
    divergence, golden-locked in ``test_scale_pose_degenerate_frames_golden``.
    """
    lo = np.nanmin(xy, axis=-2, keepdims=True)
    hi = np.nanmax(xy, axis=-2, keepdims=True)
    span = hi - lo
    safe = np.where(span == 0, 1.0, span)
    out = (xy - lo) / safe * 2.0 - 1.0
    return np.where(span == 0, 0.0, out)


def scale_pose_torch(xy: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`scale_pose` for tensors on any device (no NaN
    handling needed once the pipeline has already dropped NaN windows)."""
    lo = xy.amin(dim=-2, keepdim=True)
    hi = xy.amax(dim=-2, keepdim=True)
    span = hi - lo
    safe = torch.where(span == 0, torch.ones_like(span), span)
    return torch.where(span == 0, torch.zeros_like(xy), (xy - lo) / safe * 2.0 - 1.0)


def add_center_joint(pose: np.ndarray) -> np.ndarray:
    """Append a synthetic center joint = midpoint of joints 1 and 2.

    ``pose``: (..., V, C); returns (..., V+1, C). Matches
    ``har_create4.py:112`` (13 -> 14 joints for ``coco_cut``).
    """
    center = (pose[..., 1, :] + pose[..., 2, :]) / 2.0
    return np.concatenate([pose, center[..., None, :]], axis=-2)


def score_weighted_labels(
    labels: np.ndarray, scores: np.ndarray, boost: float = 1.5,
    has_center: bool = True,
) -> np.ndarray:
    """Scale per-frame label rows by the mean keypoint confidence.

    Main parts (shoulders/hips/center) are boosted ``boost``x and clipped to
    1 before the mean (``har_create4.py:114-123``). The reference always
    appends the center joint before this step, so index -1 IS the center;
    with ``has_center=False`` (center joint not appended) the -1 slot would
    be a real joint (RAnkle) — boost only the shoulder/hip parts then.
    """
    scr = scores.copy()
    idx = np.asarray(MAIN_IDX_PARTS if has_center else MAIN_IDX_PARTS[:-1])
    scr[..., idx] = np.minimum(scr[..., idx] * boost, 1.0)
    return labels * scr.mean(axis=-1, keepdims=True)


def epsilon_smooth(onehot: np.ndarray, eps: float = 0.1) -> np.ndarray:
    """y*(1-eps) + (1-y)*eps/(C-1) (``har_create4.py:92``)."""
    c = onehot.shape[-1]
    return onehot * (1.0 - eps) + (1.0 - onehot) * eps / (c - 1)


def seq_label_smoothing(labels: np.ndarray, max_step: int = 10) -> np.ndarray:
    """Ramp labels linearly across class-transition boundaries, in place
    semantics of the reference state machine (``har_create4.py:54-78``).

    Scanning forward, when the argmax class changes within the next
    ``max_step`` frames, the ``steps`` frames before the change fade the
    active class from ``max_val`` down and the target class up; a 0 target
    value is replaced by ``min_val``.
    """
    out = labels.copy()
    n = out.shape[0]
    max_val = float(out.max())
    min_val = float(out.min())

    steps = 0
    remain = 0
    start_change = 0
    active = 0
    target = 0
    for i in range(n):
        if remain > 0:
            if i >= start_change:
                out[i, active] = max_val * remain / steps
                ramp_up = max_val * (steps - remain) / steps
                out[i, target] = ramp_up if ramp_up else min_val
                remain -= 1
            continue
        window_arg = np.argmax(out[i : i + max_step], axis=1)
        changed = np.where(window_arg - np.argmax(out[i]) != 0)[0]
        if len(changed) > 0:
            start_change = i  # remain is 0 here (reference: i + remain // 2)
            steps = int(changed[0])
            remain = steps
            target = int(np.argmax(out[i + remain]))
            active = int(np.argmax(out[i]))
    return out


def segment_continuous(frames: Sequence[int], max_gap: int = 10) -> List[np.ndarray]:
    """Split row indices into runs where successive frame numbers advance by
    less than ``max_gap`` (``har_create4.py:96-105``)."""
    frames = np.asarray(frames)
    if len(frames) == 0:
        return []
    breaks = np.where(frames[1:] >= frames[:-1] + max_gap)[0] + 1
    return np.split(np.arange(len(frames)), breaks)


def sliding_windows(arr: np.ndarray, seq_len: int, drop_last: bool = True) -> np.ndarray:
    """Stride-1 windows over the leading axis: (N, ...) -> (N', seq_len, ...).

    ``drop_last=True`` matches the reference's ``range(len - n_frames)``
    (the final full window is *excluded*, ``har_create4.py:125``);
    ``drop_last=False`` matches Gen-3's ``range(0, row)`` with short-window
    filtering (``Multimodal_Fall3/dataloader.py:51-56``), i.e. includes it.
    """
    n = arr.shape[0]
    count = n - seq_len + (0 if drop_last else 1)
    if count <= 0:
        return np.empty((0, seq_len) + arr.shape[1:], dtype=arr.dtype)
    view = np.lib.stride_tricks.sliding_window_view(arr, seq_len, axis=0)
    # sliding_window_view puts the window axis last; bring it to axis 1.
    view = np.moveaxis(view, -1, 1)
    return np.ascontiguousarray(view[:count])


def window_video(
    pose: np.ndarray,
    labels: np.ndarray,
    seq_len: int = 30,
    sensor: np.ndarray | None = None,
    drop_last: bool = True,
) -> Tuple[np.ndarray, ...]:
    """Window one continuous segment into training samples.

    ``pose``: (F, V, C); ``labels``: (F, K); optional ``sensor``: (F, S).
    Window labels are the mean label over the window
    (``har_create4.py:127``). Returns (features, window_labels[, sensors]).
    """
    feats = sliding_windows(pose, seq_len, drop_last)
    labs = sliding_windows(labels, seq_len, drop_last).mean(axis=1)
    if sensor is None:
        return feats, labs
    sens = sliding_windows(sensor, seq_len, drop_last)
    return feats, labs, sens
