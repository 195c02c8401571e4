"""Dataset ingestion: windowed pickles, CSV directories or synthetic data
-> host :class:`WindowedDataset` -> splits and folds.

Counterpart of the JAX package's ``data/loaders.py``:

* **Windowed pickles** (Gen 1/2 prep output, ``har_create4_sensor.py:146``):
  ``(video_names, features(N,T,V,3), sensors(N,T,S), labels(N,K))`` or the
  sensor-less ``(features, labels)`` / ``(video_names, features, labels)``.
* **CSV-direct** (Gen 3, ``Multimodal_Fall3/dataloader.py:21-297``): a
  directory tree of per-video CSVs with columns
  ``video, frame, <13 joints x (x,y,score)>, label``; windows are sliced
  stride-1 per video by the native slicer (:mod:`.native`), NaN or short
  windows dropped, the window label is the mean one-hot over its frames, and
  pose is re-normalised and center-joint-extended once at load. The JAX
  package reads the CSVs with pandas; this loader reads them with ``csv``
  and numpy and reproduces pandas' results (:func:`load_csv_windows`).
* **Synthetic** windows with a dataset's canonical shapes when no path is
  given (:func:`~fall_multimodal_tpu_torch.data.synthetic.make_synthetic`).

Features keep the layout ``(N, T, V, C)`` end to end.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from fall_multimodal_tpu_torch.data.preprocess import add_center_joint, scale_pose
from fall_multimodal_tpu_torch.data.splits import (
    kfold_indices,
    stratified_kfold_indices,
    train_valid_test_split,
)
from fall_multimodal_tpu_torch.data.synthetic import WindowedDataset, make_synthetic


def load_pickle_windows(paths: Union[str, Sequence[str]]) -> WindowedDataset:
    """Load and concatenate Gen-1/2 windowed pickles. A bare path loads one
    file (a string would otherwise iterate as characters). Pickles run code
    when read: load only files this pipeline wrote."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    videos: List[np.ndarray] = []
    feats: List[np.ndarray] = []
    sens: List[np.ndarray] = []
    labs: List[np.ndarray] = []
    has_sensor = True
    for path in paths:
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        if len(blob) == 4:
            vid, f, s, l = blob
        elif len(blob) == 3:
            vid, f, l = blob
            s, has_sensor = None, False
        elif len(blob) == 2:
            f, l = blob
            vid = np.asarray([f"{os.path.basename(path)}:{i}" for i in range(len(f))])
            s, has_sensor = None, False
        else:
            raise ValueError(f"Unrecognized pickle structure in {path}")
        videos.append(np.asarray(vid))
        feats.append(np.asarray(f, dtype=np.float32))
        labs.append(np.asarray(l, dtype=np.float32))
        if s is not None:
            sens.append(np.asarray(s, dtype=np.float32))

    if sens and not has_sensor:
        # a silent drop here would train a multimodal model on the all-zeros
        # sensor placeholder
        raise ValueError(
            "inconsistent pickles: some files carry a sensor stream and "
            "some do not — load them separately or regenerate the "
            "sensorless files with sensor windows"
        )
    return WindowedDataset(
        features=np.concatenate(feats),
        labels=np.concatenate(labs),
        sensors=np.concatenate(sens) if has_sensor and sens else None,
        videos=np.concatenate(videos),
    )


# The cells ``pandas.read_csv`` reads as missing by default.
_NA_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
              "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
              "nan", "null")


def _read_csv(path: str):
    """(header, rows of str) of one CSV file; blank lines skipped and short
    rows padded with missing cells, as ``pandas.read_csv`` does."""
    with open(path, newline="") as fh:
        rows = [row for row in csv.reader(fh) if row]
    if not rows:
        raise ValueError(f"{path!r} has no header row")
    header, body = rows[0], rows[1:]
    for i, row in enumerate(body):
        if len(row) > len(header):
            raise ValueError(f"{path!r} line {i + 2}: {len(row)} fields, header has "
                             f"{len(header)}")
        if len(row) < len(header):
            body[i] = row + [""] * (len(header) - len(row))
    return header, body


def _typed_column(cells: np.ndarray) -> np.ndarray:
    """One column as ``pandas.read_csv`` types it: int64 when every cell is an
    integer, float64 (missing cells NaN) when every present cell is a number,
    else an object array of str with NaN for missing cells."""
    missing = np.isin(cells, _NA_VALUES)
    present = cells[~missing]
    if not missing.any():
        try:
            return present.astype(np.int64)
        except ValueError:
            pass
    try:
        out = np.full(len(cells), np.nan)
        out[~missing] = present.astype(np.float64)
        return out
    except ValueError:
        out = cells.astype(object)
        out[missing] = np.nan
        return out


def _sort_codes(col: np.ndarray, name: str) -> np.ndarray:
    """Rank of each value in sorted order, missing values last (pandas'
    ``sort_values(na_position="last")``)."""
    if col.dtype == object and any(isinstance(v, float) for v in col):
        raise ValueError(f"column {name!r} mixes text and missing cells")
    return np.unique(col, return_inverse=True)[1].reshape(-1)


def load_csv_windows(
    dataset_dir: str,
    seq_len: int = 30,
    rescale_pose: bool = True,
    center_joint: bool = True,
) -> WindowedDataset:
    """Gen-3 CSV-direct loader (host side, runs once): the JAX package's
    ``load_csv_windows`` without pandas, with pandas' results:

    * every ``*.csv`` under ``dataset_dir`` in sorted path order, their
      columns united in order of first appearance (a file lacking one has
      missing cells there);
    * cells typed as ``read_csv`` types them (``_typed_column``);
    * the one-hot label columns in sorted order of the label values,
      numeric when every label is a number (``get_dummies``; a missing
      label is an all-zero row);
    * rows stably sorted by ``(video, frame)``, missing values last;
    * feature columns: every column but ``video``, ``frame`` and ``label``,
      in header order;
    * windows with a missing or NaN feature cell rejected by the slicer.
    """
    from fall_multimodal_tpu_torch.data.native import slice_windows, window_mean_labels

    csv_paths = sorted(os.path.join(root, f) for root, _, files in os.walk(dataset_dir)
                       for f in files if f.endswith(".csv"))
    if not csv_paths:
        raise FileNotFoundError(f"No CSVs under {dataset_dir}")
    tables = [_read_csv(p) for p in csv_paths]
    names: List[str] = []
    for header, _ in tables:
        names += [h for h in header if h not in names]
    for need in ("video", "frame", "label"):
        if need not in names:
            raise ValueError(f"CSVs under {dataset_dir} have no {need!r} column")
    cells = {}
    for name in names:
        parts = []
        for header, body in tables:
            if name in header:
                j = header.index(name)
                parts.append(np.asarray([row[j] for row in body], dtype=str))
            else:
                parts.append(np.full(len(body), "", dtype=str))
        cells[name] = _typed_column(np.concatenate(parts))

    video, frame, label = cells["video"], cells["frame"], cells["label"]
    order = np.lexsort((_sort_codes(frame, "frame"), _sort_codes(video, "video")))
    labelled = ~np.asarray([isinstance(v, float) and np.isnan(v) for v in label]) \
        if label.dtype == object else ~np.isnan(label)
    classes, class_of = np.unique(label[labelled], return_inverse=True)
    onehot = np.zeros((len(label), len(classes)), np.float32)
    onehot[np.flatnonzero(labelled), class_of.reshape(-1)] = 1.0
    features = [n for n in names if n not in ("video", "frame", "label")]
    for name in features:
        if cells[name].dtype == object:
            raise ValueError(f"feature column {name!r} holds text")
    skel = np.stack([cells[n] for n in features], axis=1).astype(np.float32)[order]
    labs = onehot[order]
    video_names, video_codes = np.unique(video[order], return_inverse=True)
    video_codes = video_codes.reshape(-1).astype(np.int64)

    windows, starts = slice_windows(skel, video_codes, seq_len, include_last=True)
    l_means = window_mean_labels(labs, starts, seq_len)
    vids = video_names[video_codes[starts]]
    feats = windows.reshape(-1, seq_len, skel.shape[1] // 3, 3)
    if rescale_pose:
        feats = feats.copy()
        feats[..., :2] = scale_pose(feats[..., :2])
    if center_joint:
        feats = add_center_joint(feats)
    return WindowedDataset(features=feats, labels=l_means, videos=vids)


# Canonical shapes per dataset name, used only when the caller doesn't say.
_SHAPE_PRESETS = {
    "harup": dict(num_classes=11, sensor_dim=15),
    "urfall": dict(num_classes=2, sensor_dim=4),
    "imvia": dict(num_classes=2, sensor_dim=0),
    "fukinect": dict(num_classes=4, sensor_dim=0),
}


def load_dataset(
    dataset: str,
    path: Optional[str] = None,
    seq_len: int = 30,
    num_joints: int = 14,
    num_classes: Optional[int] = None,
    sensor_dim: Optional[int] = None,
    seed: int = 0,
    n_windows: int = 1024,
) -> WindowedDataset:
    """Uniform entry: real data when ``path`` is given, else synthetic with
    the dataset's canonical shapes (explicit args always win)."""
    if path is not None:
        # sequence of pickle paths first: os.path.isdir(list) raises
        if not isinstance(path, (str, os.PathLike)):
            return load_pickle_windows(list(path))
        if os.path.isdir(path):
            return load_csv_windows(path, seq_len=seq_len)
        return load_pickle_windows([path])
    preset = _SHAPE_PRESETS.get(dataset, {})
    return make_synthetic(
        n_windows=n_windows,
        seq_len=seq_len,
        num_joints=num_joints,
        num_classes=num_classes if num_classes is not None else preset.get("num_classes", 11),
        sensor_dim=sensor_dim if sensor_dim is not None else preset.get("sensor_dim", 15),
        seed=seed,
    )


def split_dataset(
    data: WindowedDataset,
    split=(0.6, 0.2, 0.2),
    seed: int = 42,
    by_video: bool = True,
) -> Dict[str, WindowedDataset]:
    idx = train_valid_test_split(data.videos, split=split, seed=seed, by_video=by_video)
    return {name: data.subset(i) for name, i in idx.items()}


def kfold_datasets(
    data: WindowedDataset,
    n_folds: int = 10,
    seed: int = 42,
    by_video: bool = True,
    stratify: bool = False,
) -> List[Dict[str, WindowedDataset]]:
    """``stratify=True``: sample-level stratified folds (the notebook
    ``KFold_load_dataset`` protocol; overrides ``by_video``); otherwise
    plain or video-level k-fold."""
    if stratify:
        folds = stratified_kfold_indices(data.labels, n_folds=n_folds, seed=seed)
    else:
        folds = kfold_indices(data.videos, n_folds=n_folds, seed=seed, by_video=by_video)
    return [{name: data.subset(i) for name, i in fold.items()} for fold in folds]
