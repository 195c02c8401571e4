"""The port's native window slicer, Gen-3 CSV loader and k-fold datasets
against the JAX package's (``data/native.py``, ``data/loaders.py``), on the
CPU. The port reads the CSVs without pandas; the JAX package reads them with
pandas, so equality here is equality with pandas' parsing, typing, one-hot
column order and sort."""

import os

import numpy as np
import pytest

from fall_multimodal_tpu.data import loaders as jax_loaders
from fall_multimodal_tpu.data import native as jax_native
from fall_multimodal_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from fall_multimodal_tpu_torch.data import (
    kfold_datasets,
    load_csv_windows,
    load_dataset,
    make_synthetic,
)
from fall_multimodal_tpu_torch.data import native


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(3)
    n, f = 1500, 12
    data = rng.normal(size=(n, f)).astype(np.float32)
    data[rng.integers(0, n, 15), rng.integers(0, f, 15)] = np.nan
    codes = np.repeat(np.arange(n // 100), 100).astype(np.int64)
    return data, codes


def test_native_slicer_is_built_in_the_port():
    assert native.native_available()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.startswith(os.path.dirname(os.path.abspath(native.__file__)))


@pytest.mark.parametrize("include_last", [True, False])
@pytest.mark.parametrize("seq_len", [1, 7, 30])
def test_slicers_equal_each_other_and_the_jax_package(table, include_last, seq_len):
    data, codes = table
    w_nat, s_nat = native.slice_windows(data, codes, seq_len, include_last)
    w_np, s_np = native.slice_windows_numpy(data, codes, seq_len, include_last)
    w_jax, s_jax = jax_native.slice_windows(data, codes, seq_len, include_last)
    for w, s in ((w_np, s_np), (w_jax, s_jax)):
        np.testing.assert_array_equal(s_nat, s)
        np.testing.assert_array_equal(w_nat, w)
    assert not np.isnan(w_nat).any()
    assert (codes[s_nat] == codes[s_nat + seq_len - 1]).all()


def test_window_mean_labels_matches_the_jax_package(table):
    data, codes = table
    _, starts = native.slice_windows(data, codes, 30)
    labels = np.random.default_rng(4).random((len(data), 3)).astype(np.float32)
    ours = native.window_mean_labels(labels, starts, 30)
    np.testing.assert_allclose(ours, jax_native.window_mean_labels(labels, starts, 30),
                               rtol=0, atol=1e-6)
    ref = np.stack([labels[s: s + 30].mean(axis=0) for s in starts])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="run past"):
        native.window_mean_labels(labels, np.array([len(labels) - 3]), 30)


def test_short_input_yields_zero_windows():
    w, s = native.slice_windows(np.zeros((5, 4), np.float32), np.zeros(5, np.int64), 30)
    assert w.shape == (0, 30, 4) and len(s) == 0


def _write_tree(root, label_kind, rng):
    """Two or three videos over several files in subdirectories, frames
    shuffled within each file, one NaN cell and one missing cell, labels of
    ``label_kind``."""
    labels = {"str": ["walk", "fall", "sit", "Lie"], "int": [10, 2, 7, 1],
              "float": [0.5, 2.0, 1.25, 3.0]}[label_kind]
    cols = [f"j{j}_{a}" for j in range(13) for a in ("x", "y", "s")]
    files = {"a/v1.csv": ("v1", 45), "a/v2.csv": ("v0", 50), "b/v3.csv": ("v2", 35)}
    for rel, (video, n) in files.items():
        frames = rng.permutation(n)
        lines = [",".join(["video", "frame"] + cols + ["label"])]
        for f in frames:
            vals = [f"{v:.7f}" for v in rng.random(len(cols))]
            if video == "v1" and f == 20:
                vals[4] = "nan"
            if video == "v0" and f == 11:
                vals[7] = ""
            lab = labels[(f // 9 + len(video)) % len(labels)]
            lines.append(",".join([video, str(f)] + vals + [str(lab)]))
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("label_kind", ["str", "int", "float"])
def test_csv_tree_loads_as_the_jax_package_loads_it(tmp_path, label_kind):
    _write_tree(str(tmp_path), label_kind, np.random.default_rng(5))
    ours = load_csv_windows(str(tmp_path), seq_len=30)
    ref = jax_loaders.load_csv_windows(str(tmp_path), seq_len=30)
    assert ours.features.shape == ref.features.shape
    assert ours.labels.shape == ref.labels.shape == (len(ours), 4)
    np.testing.assert_allclose(ours.features, ref.features, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.labels, ref.labels, rtol=0, atol=1e-6)
    assert ours.videos.tolist() == ref.videos.tolist()
    # the NaN and the missing cell each remove the 30 windows that hold them
    assert len(ours) == (45 - 29 - 16) + (50 - 29 - 12) + (35 - 29)


def test_csv_tree_with_integer_videos_and_a_missing_label(tmp_path):
    rng = np.random.default_rng(6)
    lines = ["video,frame,x0,y0,s0,x1,y1,s1,x2,y2,s2,label"]
    for video in (12, 3):
        for f in rng.permutation(34):
            vals = [f"{v:.6f}" for v in rng.random(9)]
            lab = "" if (video, f) == (3, 5) else str(f % 3)
            lines.append(",".join([str(video), str(f)] + vals + [lab]))
    (tmp_path / "t.csv").write_text("\n".join(lines) + "\n")
    ours = load_csv_windows(str(tmp_path), seq_len=30)
    ref = jax_loaders.load_csv_windows(str(tmp_path), seq_len=30)
    np.testing.assert_allclose(ours.features, ref.features, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.labels, ref.labels, rtol=0, atol=1e-6)
    assert ours.videos.tolist() == ref.videos.tolist() and set(ours.videos.tolist()) == {3, 12}


def test_load_dataset_reads_a_directory(tmp_path):
    _write_tree(str(tmp_path), "str", np.random.default_rng(7))
    data = load_dataset("harup", path=str(tmp_path), seq_len=30)
    assert data.features.shape[1:] == (30, 14, 3)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No CSVs"):
        load_dataset("harup", path=str(tmp_path / "empty"), seq_len=30)


@pytest.mark.parametrize("by_video,stratify", [(True, False), (False, False), (True, True)])
def test_kfold_datasets_match_the_jax_package(by_video, stratify):
    kw = dict(n_windows=150, num_classes=3, sensor_dim=4, windows_per_video=6, seed=2)
    ours = kfold_datasets(make_synthetic(**kw), n_folds=4, seed=42, by_video=by_video,
                          stratify=stratify)
    ref = jax_loaders.kfold_datasets(jax_make_synthetic(**kw), n_folds=4, seed=42,
                                     by_video=by_video, stratify=stratify)
    assert len(ours) == len(ref) == 4
    for fo, fr in zip(ours, ref):
        assert set(fo) == set(fr) == {"train", "valid", "test"}
        for k in fo:
            np.testing.assert_array_equal(fo[k].videos, fr[k].videos)
            np.testing.assert_array_equal(fo[k].features, fr[k].features)
            np.testing.assert_array_equal(fo[k].labels, fr[k].labels)
            np.testing.assert_array_equal(fo[k].sensors, fr[k].sensors)
        if by_video and not stratify:
            assert not set(fo["train"].videos) & set(fo["test"].videos)
