"""The port's data path against the JAX package's, on the CPU: synthetic
data, splits, preprocessing and loaders byte for byte (numpy copies), the
device pipeline's index contracts, and augmentation by its properties (the
draws come from a ``torch.Generator`` and cannot equal ``jax.random``'s), as
``tests/test_augment.py`` holds the JAX package's."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu import data as jax_data
from fall_multimodal_tpu.data import augment as jax_augment
from fall_multimodal_tpu.data import preprocess as jax_pre
from fall_multimodal_tpu_torch import data as port
from fall_multimodal_tpu_torch.configs import AugmentConfig
from fall_multimodal_tpu_torch.data import preprocess as pre
from fall_multimodal_tpu_torch.data.augment import FLIP_PERMUTATIONS, make_augment_fn
from fall_multimodal_tpu_torch.graphs.topology import LAYOUTS
from torch_port_helpers import t, to_numpy

torch.set_num_threads(1)


def _same(a, b):
    for field in ("features", "labels", "sensors", "videos"):
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            assert x is None and y is None, field
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, field
        if x.dtype == object:          # names read from files: compare the values
            assert x.tolist() == y.tolist(), field
        else:
            assert x.tobytes() == y.tobytes(), field


# ------------------------------------------------------- synthetic, splits

@pytest.mark.parametrize("kw", [
    dict(), dict(n_windows=100, num_classes=2, sensor_dim=4, seed=3),
    dict(n_windows=33, sensor_dim=0, soft_labels=False, windows_per_video=5, seed=9),
])
def test_synthetic_is_byte_identical(kw):
    _same(port.make_synthetic(**kw), jax_data.make_synthetic(**kw))


@pytest.mark.parametrize("split,by_video", [((0.6, 0.2, 0.2), True), ((0.7, 0.3, 0.0), True),
                                            ((0.5, 0.25, 0.25), False)])
def test_splits_are_identical(split, by_video):
    d = port.make_synthetic(n_windows=120, num_classes=3, sensor_dim=4, seed=2)
    ours = port.split_dataset(d, split=split, seed=7, by_video=by_video)
    ref = jax_data.split_dataset(jax_data.make_synthetic(n_windows=120, num_classes=3,
                                                         sensor_dim=4, seed=2),
                                 split=split, seed=7, by_video=by_video)
    assert set(ours) == set(ref) == {"train", "valid", "test"}
    for k in ours:
        _same(ours[k], ref[k])


def test_fold_indices_are_identical():
    d = port.make_synthetic(n_windows=90, num_classes=3, sensor_dim=0, seed=4)
    for ours, ref in ((port.kfold_indices(d.videos, 4, seed=1),
                       jax_data.kfold_indices(d.videos, 4, seed=1)),
                      (port.kfold_indices(d.videos, 5, seed=1, by_video=False),
                       jax_data.kfold_indices(d.videos, 5, seed=1, by_video=False)),
                      (port.stratified_kfold_indices(d.labels, 3, seed=5),
                       jax_data.stratified_kfold_indices(d.labels, 3, seed=5))):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ preprocess

def test_preprocess_functions_match(rng):
    xy = rng.uniform(-5, 5, size=(3, 30, 13, 2))
    xy[0, 2] = 1.0                                      # a degenerate frame
    np.testing.assert_array_equal(pre.scale_pose(xy), jax_pre.scale_pose(xy))
    np.testing.assert_allclose(to_numpy(pre.scale_pose_torch(torch.as_tensor(xy))),
                               np.asarray(jax_pre.scale_pose_jnp(jnp.asarray(xy))),
                               atol=1e-6)
    pose = rng.normal(size=(40, 13, 3))
    np.testing.assert_array_equal(pre.add_center_joint(pose), jax_pre.add_center_joint(pose))
    labels = np.eye(3)[rng.integers(0, 3, size=40)]
    scores = rng.uniform(size=(40, 14))
    np.testing.assert_array_equal(pre.score_weighted_labels(labels, scores),
                                  jax_pre.score_weighted_labels(labels, scores))
    np.testing.assert_array_equal(pre.epsilon_smooth(labels), jax_pre.epsilon_smooth(labels))
    np.testing.assert_array_equal(pre.seq_label_smoothing(labels),
                                  jax_pre.seq_label_smoothing(labels))
    frames = np.r_[0:10, 25:40, 60:75]
    for a, b in zip(pre.segment_continuous(frames), jax_pre.segment_continuous(frames)):
        np.testing.assert_array_equal(a, b)
    sensor = rng.normal(size=(40, 4))
    for drop_last in (True, False):
        for a, b in zip(pre.window_video(pose, labels, 30, sensor, drop_last),
                        jax_pre.window_video(pose, labels, 30, sensor, drop_last)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- loaders

def test_pickle_loader_matches(tmp_path):
    d = port.make_synthetic(n_windows=20, num_classes=2, sensor_dim=4, seed=1)
    paths = []
    for i, blob in enumerate([(d.videos, d.features, d.sensors, d.labels),
                              (d.videos, d.features, d.sensors, d.labels)]):
        paths.append(str(tmp_path / f"w{i}.pkl"))
        with open(paths[-1], "wb") as fh:
            pickle.dump(blob, fh)
    _same(port.load_pickle_windows(paths), jax_data.load_pickle_windows(paths))
    _same(port.load_dataset("urfall", path=paths[0]), jax_data.load_dataset("urfall", path=paths[0]))
    two = str(tmp_path / "two.pkl")
    with open(two, "wb") as fh:
        pickle.dump((d.features, d.labels), fh)
    _same(port.load_pickle_windows(two), jax_data.load_pickle_windows(two))
    with pytest.raises(ValueError, match="inconsistent pickles"):
        port.load_pickle_windows([paths[0], two])


def test_load_dataset_synthetic_matches_and_csv_dirs_wait(tmp_path):
    _same(port.load_dataset("urfall", n_windows=50, seed=3),
          jax_data.load_dataset("urfall", n_windows=50, seed=3))
    _same(port.load_dataset("harup", n_windows=20), jax_data.load_dataset("harup", n_windows=20))
    # a directory is a tree of Gen-3 CSVs, read as the JAX package reads it
    for lib in (port, jax_data):
        with pytest.raises(FileNotFoundError, match="No CSVs"):
            lib.load_dataset("urfall", path=str(tmp_path))
    rng = np.random.default_rng(4)
    lines = ["video,frame," + ",".join(f"c{i}" for i in range(39)) + ",label"]
    for f in rng.permutation(40):
        lines.append(f"video_a,{f}," + ",".join(f"{v:.5f}" for v in rng.random(39))
                     + f",{'fall' if f > 20 else 'walk'}")
    (tmp_path / "a.csv").write_text("\n".join(lines) + "\n")
    _same(port.load_dataset("urfall", path=str(tmp_path)),
          jax_data.load_dataset("urfall", path=str(tmp_path)))


# --------------------------------------------------------------- pipeline

@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 8), (1, 1)])
def test_eval_batches_match(n, batch):
    np.testing.assert_array_equal(port.eval_batch_indices(n, batch),
                                  jax_data.eval_batch_indices(n, batch))
    np.testing.assert_array_equal(port.eval_batch_mask(n, batch),
                                  jax_data.eval_batch_mask(n, batch))


@pytest.mark.parametrize("n,batch", [(10, 4), (12, 4), (3, 8)])
def test_epoch_indices_contract(n, batch):
    gen = torch.Generator().manual_seed(0)
    idx = port.epoch_batch_indices(gen, n, batch, drop_last=True)
    assert idx.shape == (n // batch, batch)
    assert len(set(idx.flatten().tolist())) == idx.numel()       # no repeats
    full = port.epoch_batch_indices(gen, n, batch, drop_last=False)
    steps = -(-n // batch)
    assert full.shape == (steps, batch)
    flat = full.flatten().tolist()
    assert sorted(set(flat)) == list(range(n))                   # every window once ...
    assert len(set(flat[: n])) == n                              # ... before the wrap-around
    assert set(flat[n:]) <= set(flat[: n])
    # the same seed gives the same permutation; another seed another one
    a = port.epoch_batch_indices(torch.Generator().manual_seed(5), 50, 10)
    b = port.epoch_batch_indices(torch.Generator().manual_seed(5), 50, 10)
    c = port.epoch_batch_indices(torch.Generator().manual_seed(6), 50, 10)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_to_device_and_gather():
    d = port.make_synthetic(n_windows=12, num_classes=2, sensor_dim=0, seed=0)
    dd = port.to_device(d, "cpu")
    assert dd.n == 12 and dd.sensors.shape == (12, 1, 1) and float(dd.sensors.abs().sum()) == 0
    ref = jax_data.to_device(jax_data.make_synthetic(n_windows=12, num_classes=2,
                                                     sensor_dim=0, seed=0))
    for a, b in zip(dd, ref):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    b = port.gather_batch(dd, torch.tensor([3, 0, 3]))
    np.testing.assert_array_equal(to_numpy(b.features), d.features[[3, 0, 3]])
    np.testing.assert_array_equal(to_numpy(b.labels), d.labels[[3, 0, 3]])


def test_to_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.to_device(port.make_synthetic(n_windows=4, seed=0))


# ----------------------------------------------------------- augmentation

def _batch(rng, n=4, tt=30, v=14, c=3, s=6):
    feats = rng.uniform(-1, 1, size=(n, tt, v, c)).astype(np.float32)
    sens = rng.normal(size=(n, tt, s)).astype(np.float32)
    return t(feats), t(sens)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_disabled_or_zero_returns_none():
    assert make_augment_fn(AugmentConfig()) is None
    assert make_augment_fn(AugmentConfig(enabled=True)) is None
    assert make_augment_fn(AugmentConfig(enabled=False, rotate_deg=30)) is None
    assert make_augment_fn(AugmentConfig(enabled=True, rotate_deg=30)) is not None


def test_rotation_preserves_pairwise_distances(rng):
    feats, sens = _batch(rng)
    out, out_s = make_augment_fn(AugmentConfig(enabled=True, rotate_deg=45))(_gen(0), feats, sens)
    assert out.shape == feats.shape
    assert torch.equal(out_s, sens) and torch.equal(out[..., 2], feats[..., 2])

    def dists(x):
        xy = to_numpy(x[..., :2])
        return np.linalg.norm(xy[:, :, :, None, :] - xy[:, :, None, :, :], axis=-1)

    np.testing.assert_allclose(dists(out), dists(feats), atol=1e-5)
    assert float((out[..., :2] - feats[..., :2]).abs().max()) > 1e-3


def test_scale_and_translate(rng):
    feats, sens = _batch(rng)
    out, _ = make_augment_fn(AugmentConfig(enabled=True, scale=0.2))(_gen(1), feats, sens)
    xy0, xy1 = to_numpy(feats[..., :2]), to_numpy(out[..., :2])
    d0 = np.linalg.norm(xy0 - xy0.mean((1, 2), keepdims=True), axis=-1)
    d1 = np.linalg.norm(xy1 - xy1.mean((1, 2), keepdims=True), axis=-1)
    ratio = (d1 / np.maximum(d0, 1e-6)).reshape(len(d0), -1)
    assert np.all(ratio.std(axis=1) < 1e-3)
    assert np.all(np.abs(ratio.mean(axis=1) - 1.0) <= 0.2 + 1e-5)
    out, _ = make_augment_fn(AugmentConfig(enabled=True, translate=0.1))(_gen(2), feats, sens)
    delta = to_numpy(out[..., :2] - feats[..., :2])
    assert np.abs(delta - delta.mean(axis=(1, 2), keepdims=True)).max() < 1e-5
    assert np.abs(delta).max() <= 0.1 + 1e-6


@pytest.mark.parametrize("layout", ["coco_cut", "coco_mmpose"])
def test_flip_swaps_left_right_and_mirrors_x(rng, layout):
    v = LAYOUTS[layout].num_node
    feats, sens = _batch(rng, v=v)
    fn = make_augment_fn(AugmentConfig(enabled=True, flip_prob=1.0), layout=layout)
    out, _ = fn(_gen(3), feats, sens)
    perm = FLIP_PERMUTATIONS[layout]
    np.testing.assert_allclose(to_numpy(out[..., 0]), -to_numpy(feats[:, :, perm, 0]), atol=1e-6)
    np.testing.assert_allclose(to_numpy(out[..., 1:]), to_numpy(feats[:, :, perm, 1:]), atol=1e-6)
    out2, _ = fn(_gen(4), out, sens)
    np.testing.assert_allclose(to_numpy(out2), to_numpy(feats), atol=1e-6)


def test_flip_permutations_are_the_jax_packages_and_keep_the_topology():
    assert set(FLIP_PERMUTATIONS) == set(jax_augment.FLIP_PERMUTATIONS)
    for layout, perm in FLIP_PERMUTATIONS.items():
        np.testing.assert_array_equal(perm, jax_augment.FLIP_PERMUTATIONS[layout])
        lay = LAYOUTS[layout]
        assert (perm[perm] == np.arange(lay.num_node)).all()
        bones = {frozenset(e) for e in lay.neighbor_links}
        assert {frozenset((perm[i], perm[j])) for i, j in lay.neighbor_links} == bones
        assert perm[lay.center] == lay.center


def test_bad_configs_raise():
    with pytest.raises(ValueError, match="left/right"):
        make_augment_fn(AugmentConfig(enabled=True, flip_prob=0.5), layout="my_custom")
    with pytest.raises(ValueError, match="rotate_deg"):
        make_augment_fn(AugmentConfig(enabled=True, rotate_deg=-15))
    with pytest.raises(ValueError, match="sensor_noise"):
        make_augment_fn(AugmentConfig(enabled=True, scale=0.1, sensor_noise=-0.02))


def test_sensor_noise_and_gain(rng):
    feats, sens = _batch(rng)
    out_f, out_s = make_augment_fn(AugmentConfig(enabled=True, sensor_noise=0.05))(
        _gen(5), feats, sens)
    assert torch.equal(out_f, feats)
    assert 0.03 < float((out_s - sens).std()) < 0.07
    _, out_s = make_augment_fn(AugmentConfig(enabled=True, sensor_scale=0.3))(_gen(6), feats, sens)
    gain = to_numpy(out_s / sens).reshape(len(sens), -1)
    assert np.all(gain.std(axis=1) < 1e-4)
    assert np.all(np.abs(gain.mean(axis=1) - 1.0) <= 0.3 + 1e-5)


def test_deterministic_per_generator_seed(rng):
    feats, sens = _batch(rng)
    fn = make_augment_fn(AugmentConfig(enabled=True, rotate_deg=20, scale=0.1, translate=0.05,
                                       joint_jitter=0.01, flip_prob=0.5, sensor_noise=0.02,
                                       sensor_scale=0.1))
    a, b, c = fn(_gen(7), feats, sens), fn(_gen(7), feats, sens), fn(_gen(8), feats, sens)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float((a[0] - c[0]).abs().max()) > 1e-4
