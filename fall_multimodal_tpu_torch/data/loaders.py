"""Dataset ingestion: windowed pickles or synthetic data -> host
:class:`WindowedDataset` -> splits.

Counterpart of the JAX package's ``data/loaders.py:37-82,144-182``:

* **Windowed pickles** (Gen 1/2 prep output, ``har_create4_sensor.py:146``):
  ``(video_names, features(N,T,V,3), sensors(N,T,S), labels(N,K))`` or the
  sensor-less ``(features, labels)`` / ``(video_names, features, labels)``.
* **Synthetic** windows with a dataset's canonical shapes when no path is
  given (:func:`~fall_multimodal_tpu_torch.data.synthetic.make_synthetic`).

The Gen-3 CSV directory format is not read yet: it needs the native window
slicer of the JAX package's ``data/native.py``, which a later slice of the
port brings over. A directory path raises ``NotImplementedError`` until then.

Features keep the layout ``(N, T, V, C)`` end to end.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from fall_multimodal_tpu_torch.data.splits import train_valid_test_split
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
            raise NotImplementedError(
                f"{path!r} is a directory: the Gen-3 CSV loader (native window "
                "slicing) is not ported yet; it is queued for the slice that "
                "ports cross-validation and the CLI's remaining modes. Pass a "
                "windowed pickle instead.")
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
