"""Dataset split protocols.

The load-bearing invariant of the reference (``dataloader.py:65-80``,
``cv_dataloader.py:66-78``): splits are made over *unique video names*, not
windows, so stride-1 windows from one video never leak across train/test.
Gen-3 (``Multimodal_Fall3/dataloader.py:63-67``) splits window samples
directly; both protocols are provided.

The PyTorch port's own copy of the JAX package's ``data/splits.py`` (numpy
only, unchanged), so the same seed gives the same splits.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def train_valid_test_split(
    video_of_sample: Sequence,
    split: Tuple[float, float, float] = (0.6, 0.2, 0.2),
    seed: int = 42,
    by_video: bool = True,
) -> Dict[str, np.ndarray]:
    """Index split into train/valid/test.

    ``by_video=True``: shuffle unique video names, allocate whole videos to
    splits by the requested fractions (of videos, matching the reference's
    train_test_split over unique names). ``by_video=False``: split sample
    indices directly (Gen-3 protocol).
    """
    video_of_sample = np.asarray(video_of_sample)
    n_samples = len(video_of_sample)
    rng = np.random.default_rng(seed)
    if not np.isclose(sum(split), 1.0):
        raise ValueError(f"split fractions must sum to 1, got {split}")

    if by_video:
        units = np.unique(video_of_sample)
    else:
        units = np.arange(n_samples)
    perm = rng.permutation(len(units))
    n_train = int(round(split[0] * len(units)))
    n_valid = int(round(split[1] * len(units)))
    groups = {
        "train": units[perm[:n_train]],
        "valid": units[perm[n_train : n_train + n_valid]],
        "test": units[perm[n_train + n_valid :]],
    }
    if split[2] == 0:  # reference: test aliases valid when no test fraction
        # valid takes ALL remaining units — with round() both fractions can
        # round down, and the leftover must not be silently dropped
        groups["valid"] = units[perm[n_train:]]
        groups["test"] = groups["valid"]

    out: Dict[str, np.ndarray] = {}
    for name, members in groups.items():
        if by_video:
            out[name] = np.where(np.isin(video_of_sample, members))[0]
        else:
            out[name] = np.sort(members)
    return out


def stratified_kfold_indices(
    labels: Sequence,
    n_folds: int = 10,
    seed: int = 42,
) -> List[Dict[str, np.ndarray]]:
    """Sample-level stratified k-fold (valid == test per fold).

    Capability of ``KFold_load_dataset`` (``GSTCAN_HAR_conv_10kfold.ipynb:5``,
    sklearn ``StratifiedKFold(shuffle=True, random_state=42)``), re-derived
    without sklearn: per class, shuffle that class's sample indices and deal
    them round-robin over folds, rotating the starting fold across classes
    so the ±1 remainders don't pile onto fold 0. Every fold ends up with the
    class distribution of the whole set to within one sample per class.

    ``labels``: (N,) int classes or (N, K) one-hot/soft rows.
    """
    y = np.asarray(labels)
    if y.ndim > 1:
        y = y.argmax(axis=-1)
    n = len(y)
    if n_folds < 2 or n_folds > n:
        raise ValueError(f"n_folds={n_folds} invalid for {n} samples")
    rng = np.random.default_rng(seed)
    fold_of = np.empty(n, np.int64)
    start = 0
    for c in np.unique(y):
        idx = rng.permutation(np.where(y == c)[0])
        fold_of[idx] = (start + np.arange(len(idx))) % n_folds
        start = (start + len(idx)) % n_folds

    folds = []
    for f in range(n_folds):
        test_idx = np.where(fold_of == f)[0]
        train_idx = np.where(fold_of != f)[0]
        folds.append({"train": train_idx, "valid": test_idx, "test": test_idx})
    return folds


def kfold_indices(
    video_of_sample: Sequence,
    n_folds: int = 10,
    seed: int = 42,
    by_video: bool = True,
) -> List[Dict[str, np.ndarray]]:
    """K-fold CV over unique videos (valid == test per fold, as in the
    reference CV driver ``cv_dataloader.py:157-189``)."""
    video_of_sample = np.asarray(video_of_sample)
    units = (
        np.unique(video_of_sample) if by_video else np.arange(len(video_of_sample))
    )
    if n_folds > len(units):
        raise ValueError(
            f"n_folds={n_folds} exceeds the {len(units)} available "
            f"{'unique videos' if by_video else 'samples'} — empty folds "
            "would crash downstream"
        )
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(units))
    fold_unit_ids = np.array_split(perm, n_folds)

    folds = []
    for held_out in fold_unit_ids:
        held_units = units[held_out]
        if by_video:
            test_mask = np.isin(video_of_sample, held_units)
            test_idx = np.where(test_mask)[0]
            train_idx = np.where(~test_mask)[0]
        else:
            test_idx = np.sort(held_units)
            train_idx = np.sort(np.setdiff1d(units, held_units))
        folds.append({"train": train_idx, "valid": test_idx, "test": test_idx})
    return folds
