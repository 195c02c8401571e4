"""Fused-epoch training in the port (``train/loop.py``: the ``"scan"`` epoch
impl, ``equal_chunk``, ``fit(scan_epochs=...)``; ``train/cv_vmapped.py``'s
fused driver) against the JAX package's and against the port's own
per-epoch loop, on the CPU.

Tolerances: the port's scan epoch against the JAX package's scan epoch on
the same index matrices 1e-4 relative (two float32 implementations, as
``tests/test_torch_train_parity.py``); the port's fused runs against its
per-epoch runs 1e-6 (the same operations in the same order; the checks
below find them equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.data import make_synthetic as jax_make_synthetic
from fall_multimodal_tpu.data import split_dataset as jax_split_dataset
from fall_multimodal_tpu.data import to_device as jax_to_device
from fall_multimodal_tpu.data.pipeline import DeviceData as JaxDeviceData
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.train import build_optimizer as jax_build_optimizer
from fall_multimodal_tpu.train import create_train_state as jax_create_train_state
from fall_multimodal_tpu.train import fit as jax_fit
from fall_multimodal_tpu.train import make_train_epoch as jax_make_train_epoch
from fall_multimodal_tpu.train.loop import equal_chunk as jax_equal_chunk
from fall_multimodal_tpu.train.state import TrainState as JaxTrainState
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import make_synthetic, split_dataset, to_device
from fall_multimodal_tpu_torch.data.pipeline import DeviceData
from fall_multimodal_tpu_torch.interop import load_into, state_dict_from_jax_variables
from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state, fit
from fall_multimodal_tpu_torch.train.cv_vmapped import cross_validate_vmapped
from fall_multimodal_tpu_torch.train.loop import (
    equal_chunk,
    make_eval_epoch,
    make_train_epoch,
    resolve_epoch_impl,
)
from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer
from torch_port_helpers import random_init, t, to_numpy

torch.set_num_threads(1)

TINY = ((16, 1, False), (16, 1, True), (32, 2, True))
BILSTM = {"data.num_classes": 3, "data.sensor_dim": 6, "model.kwargs.hidden_size": 8}
TOL = 1e-6


def _flagship(**train):
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, kwargs=dict(cfg.model.kwargs, stages=TINY)),
        train=dataclasses.replace(cfg.train, **train))


def _splits(cfg, n=160, seed=0):
    d = cfg.data
    data = make_synthetic(n_windows=n, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          noise=0.05, windows_per_video=8, seed=seed)
    return {k: to_device(v, "cpu")
            for k, v in split_dataset(data, split=(0.7, 0.15, 0.15), seed=1).items()}


def _fit(cfg, splits, epochs, state=None, **kw):
    state = state or create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed,
                                        device="cpu")
    return fit(state, splits, epochs=epochs, batch_size=cfg.train.batch_size,
               num_classes=cfg.data.num_classes, softmax_before_ce=cfg.model.softmax_output,
               shuffle_seed=cfg.seed, **kw)


def _assert_same_state(a, b):
    """Every field of two train states: weights and buffers, the optimizer's
    state, counters and learning rates, the step, the generator."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_allclose(to_numpy(sa[k]).astype(np.float64),
                                   to_numpy(sb[k]).astype(np.float64), atol=TOL, err_msg=k)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (oa["mini_step"], oa["gradient_step"]) == (ob["mini_step"], ob["gradient_step"])
    assert oa["inner"]["param_groups"] == ob["inner"]["param_groups"]
    assert oa["inner"]["state"].keys() == ob["inner"]["state"].keys()
    for i, entries in oa["inner"]["state"].items():
        assert entries.keys() == ob["inner"]["state"][i].keys()
        for key, v in entries.items():
            np.testing.assert_allclose(to_numpy(v), to_numpy(ob["inner"]["state"][i][key]),
                                       atol=TOL, err_msg=f"{i}.{key}")
    if oa["acc"] is not None:
        for x, y in zip(oa["acc"], ob["acc"]):
            np.testing.assert_allclose(to_numpy(x), to_numpy(y), atol=TOL)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _assert_same_run(a, b):
    for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(a.history[k], b.history[k], atol=TOL, err_msg=k)
    assert len(a.history["epoch_time"]) == len(b.history["epoch_time"])
    assert a.best_val_accuracy == pytest.approx(b.best_val_accuracy, abs=TOL)
    for k in ("accuracy", "macro_f1", "micro_f1"):
        assert float(a.test.stats[k]) == pytest.approx(float(b.test.stats[k]), abs=TOL)
    np.testing.assert_array_equal(a.test.confusion, b.test.confusion)
    _assert_same_state(a.best_state, b.best_state)
    _assert_same_state(a.state, b.state)


# ------------------------------------------------------------- the scan epoch

@pytest.fixture(scope="module")
def carried_bilstm():
    """bilstm (3 classes) in both packages from the same seeded variables,
    and 96 windows made with numpy."""
    jcfg = jax_load_config(jax_preset_path("bilstm"), overrides=BILSTM)
    cfg = load_config(preset_path("bilstm"), overrides=BILSTM)
    rng = np.random.default_rng(3)
    data = make_synthetic(n_windows=96, num_classes=3, sensor_dim=6, windows_per_video=8,
                          seed=3)
    jmodel = jax_build_model(jcfg)
    variables = random_init(jmodel, rng, jnp.asarray(data.features[:2]),
                            jnp.asarray(data.sensors[:2]), train=False)
    return jcfg, cfg, jmodel, variables, data


def test_scan_epoch_matches_the_jax_scan_epoch(carried_bilstm):
    """Two epochs of the port's ``impl="scan"`` epoch and of the JAX
    package's (one ``lax.scan`` each) on the same index matrices: epoch
    losses at 1e-4 relative, step counts equal, per-step gradient norms of
    the same shape."""
    jcfg, cfg, jmodel, variables, data = carried_bilstm
    optimizer = jax_build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32),
                           rng=jax.random.key(0))
    jepoch = jax_make_train_epoch(jmodel, optimizer, impl="scan", grad_norms=True)
    state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
    load_into(state.model, state_dict_from_jax_variables(cfg, variables))
    epoch = make_train_epoch(impl="scan", grad_norms=True)
    jdata = JaxDeviceData(jnp.asarray(data.features), jnp.asarray(data.labels),
                          jnp.asarray(data.sensors))
    port_data = DeviceData(t(data.features), t(data.labels), t(data.sensors))
    rng = np.random.default_rng(11)
    for _ in range(2):
        idx = rng.permutation(96)[:96 // 16 * 16].reshape(-1, 16)
        jstate, jm = jepoch(jstate, jdata, jnp.asarray(idx))
        state, m = epoch(state, port_data, idx)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        assert {v.shape for v in m["grad_norms"].values()} == {(6,)}
        assert len(m["grad_norms"]) == len(jax.tree.leaves(jm["grad_norms"]))
    assert state.step == int(jstate.step) == 12


def test_scan_and_host_epochs_are_the_same_operations():
    cfg = _flagship(batch_size=16)
    data = _splits(cfg)["train"]
    idx = np.random.default_rng(0).permutation(data.n)[:64].reshape(4, 16)
    out = {}
    for impl in ("scan", "host"):
        state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
        state, m = make_train_epoch(impl=impl)(state, data, idx)
        out[impl] = (state, m)
    (a, ma), (b, mb) = out["scan"], out["host"]
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["accuracy"], mb["accuracy"])
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert resolve_epoch_impl("auto", "cpu") == "host"
    assert resolve_epoch_impl("auto", "cuda") == "scan"
    with pytest.raises(ValueError, match="scan|host|auto"):
        make_train_epoch(impl="unrolled")


@pytest.mark.parametrize("n", [0, 1, 6, 7, 12, 100])
def test_equal_chunk_is_the_jax_package_s(n):
    for chunk in (1, 2, 3, 5, 33, 200):
        assert equal_chunk(n, chunk) == jax_equal_chunk(n, chunk)


def test_confusion_counts_equal_bincount():
    """The eval epoch's ``index_add_`` counts (no host read on the card)
    equal ``torch.bincount``'s on random labels under a 0/1 mask."""
    g = torch.Generator().manual_seed(0)
    k = 5
    flat = torch.randint(0, k * k, (1000,), generator=g)
    mask = (torch.rand(1000, generator=g) > 0.3).float()
    cm = torch.zeros(k * k).index_add_(0, flat, mask)
    assert torch.equal(cm, torch.bincount(flat, weights=mask, minlength=k * k).float())
    cfg = load_config(preset_path("bilstm"), overrides=BILSTM)
    data = _splits(cfg, n=96)["valid"]
    state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
    n = data.n
    idx = np.minimum(np.arange(32), n - 1).reshape(2, 16)
    emask = (np.arange(32) < n).reshape(2, 16)
    cm, _ = make_eval_epoch(3)(state, data, idx, emask)
    with torch.no_grad():
        logits = state.model.eval()(data.features, data.sensors)
    flat = data.labels.argmax(-1) * 3 + logits.argmax(-1)
    assert torch.equal(cm.flatten(), torch.bincount(flat, minlength=9).float())


# ------------------------------------------------------------- the fused fit

@pytest.mark.parametrize("variant", ["rmsprop", "adam_accum2"])
def test_fused_fit_equals_the_per_epoch_fit(variant):
    """As the JAX package's ``test_fit_fused_epoch_scan_matches_per_epoch_loop``:
    ``scan_epochs=True`` (one chunk), ``2`` (chunks of 2) and ``None`` with
    the scan impl (fused by default) against ``False``, each from one
    state, and chunks of 2 under Adam with two micro-steps an update (the
    optimizer's state appears after the first epoch's snapshot): the curves, the best accuracy, the test metrics and every field
    of the best and the final states."""
    train = dict(batch_size=8)
    if variant == "adam_accum2":
        train["accum_iter"] = 2
    cfg = _flagship(**train)
    if variant == "adam_accum2":
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, type="adam", lr=3e-3))
    splits = _splits(cfg, n=96)
    state0 = create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed, device="cpu")
    per_epoch = _fit(cfg, splits, 4, state0.snapshot(), scan_epochs=False)
    assert len(set(per_epoch.history["val_acc"])) > 1        # the best state moves
    for scan_epochs in ((True, 2, None) if variant == "rmsprop" else (2,)):
        fused = _fit(cfg, splits, 4, state0.snapshot(), scan_epochs=scan_epochs,
                     epoch_impl="scan")
        _assert_same_run(per_epoch, fused)


def test_fused_fit_resumes_as_the_per_epoch_fit():
    """``start_epoch``, ``initial_best_acc`` and ``initial_best_state`` seed
    the fused run as they seed the per-epoch one; a run already complete
    trains nothing and keeps the initial best."""
    cfg = _flagship(batch_size=8)
    splits = _splits(cfg, n=96)
    state0 = create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed, device="cpu")
    first = _fit(cfg, splits, 2, state0.snapshot(), scan_epochs=False)
    runs = [_fit(cfg, splits, 4, first.state.snapshot(), scan_epochs=se, epoch_impl="scan",
                 start_epoch=3, initial_best_acc=first.best_val_accuracy,
                 initial_best_state=first.best_state.snapshot())
            for se in (False, True)]
    _assert_same_run(*runs)
    done = _fit(cfg, splits, 2, first.state.snapshot(), scan_epochs=True, epoch_impl="scan",
                start_epoch=3, initial_best_acc=0.5,
                initial_best_state=first.best_state.snapshot())
    assert done.history["train_loss"] == [] and done.best_val_accuracy == 0.5
    _assert_same_state(done.best_state, first.best_state)


@pytest.fixture(scope="module")
def jax_nan_run():
    """The JAX package's own fused fit of bilstm with a learning rate that
    blows up in the first epoch."""
    jcfg = jax_load_config(jax_preset_path("bilstm"),
                           overrides=dict(BILSTM, **{"optim.lr": 1e30, "train.max_norm": 0}))
    data = jax_make_synthetic(n_windows=96, num_classes=3, sensor_dim=6, windows_per_video=8,
                              noise=0.05, seed=0)
    splits = {k: jax_to_device(v) for k, v in jax_split_dataset(
        data, split=(0.7, 0.15, 0.15), seed=1).items()}
    model, optimizer = jax_build_model(jcfg), jax_build_optimizer(jcfg)
    state = jax_create_train_state(model, optimizer, splits["train"].features[:2],
                                   splits["train"].sensors[:2], seed=0)
    return jax_fit(model, optimizer, state, splits, epochs=3, batch_size=16, num_classes=3,
                   epoch_impl="scan", scan_epochs=True)


def test_non_finite_loss_truncates_the_history_as_the_jax_package_does(jax_nan_run):
    cfg = load_config(preset_path("bilstm"),
                      overrides=dict(BILSTM, **{"optim.lr": 1e30, "train.max_norm": 0}))
    splits = _splits(cfg, n=96)
    runs = {se: _fit(cfg, splits, 3, scan_epochs=se, epoch_impl="scan")
            for se in (False, True)}
    shape = {k: len(v) for k, v in jax_nan_run.history.items()}
    assert shape == {"train_loss": 1, "train_acc": 0, "val_loss": 0, "val_acc": 0,
                     "epoch_time": 0}
    for run in runs.values():
        assert {k: len(v) for k, v in run.history.items()} == shape
        assert not np.isfinite(run.history["train_loss"][0])
        assert run.best_val_accuracy == jax_nan_run.best_val_accuracy == -1.0


def test_scan_epochs_refusals_are_the_jax_package_s(tmp_path):
    """``scan_epochs=True`` with per-epoch host work or the host impl raises
    in both packages; ``None`` quietly runs per epoch there."""
    cfg = load_config(preset_path("bilstm"), overrides=BILSTM)
    splits = _splits(cfg, n=96)
    refused = [dict(checkpointer=Checkpointer(str(tmp_path / "ckpt"))),
               dict(metrics_callback=lambda e, s: None),
               dict(step_metrics_callback=lambda i, s: None),
               dict(grad_norms=True),
               dict(epoch_impl="host"),
               dict(epoch_impl="auto")]                     # auto is host on the CPU
    for kw in refused:
        kw = dict({"epoch_impl": "scan"}, **kw)
        with pytest.raises(ValueError, match="scan_epochs=True"):
            _fit(cfg, splits, 1, scan_epochs=True, **kw)
    seen = []
    _fit(cfg, splits, 1, epoch_impl="scan", metrics_callback=lambda e, s: seen.append(e))
    assert seen == [1]
    jcfg = jax_load_config(jax_preset_path("bilstm"), overrides=BILSTM)
    model, optimizer = jax_build_model(jcfg), jax_build_optimizer(jcfg)
    data = jax_make_synthetic(n_windows=96, num_classes=3, sensor_dim=6, seed=0)
    jsplits = {k: jax_to_device(v) for k, v in jax_split_dataset(data, seed=1).items()}
    state = jax_create_train_state(model, optimizer, jsplits["train"].features[:2],
                                   jsplits["train"].sensors[:2], seed=0)
    for kw in refused[1:5]:
        kw = dict({"epoch_impl": "scan"}, **kw)
        with pytest.raises(ValueError, match="scan_epochs=True"):
            jax_fit(model, optimizer, state, jsplits, epochs=1, batch_size=16, num_classes=3,
                    scan_epochs=True, **kw)


# ------------------------------------------------------------- the fused CV

def _recorder(store):
    def factory(k):
        return lambda epoch, scalars: store.setdefault(k, []).append((epoch, scalars))
    return factory


def test_fused_cv_equals_the_per_epoch_cv():
    """``cross_validate_vmapped(scan_epochs=True / 2 / None with the scan
    impl)`` against ``False``, as the JAX package's
    ``tests/test_parallel.py:184-246``: per-fold curves (through
    ``metrics_factory``) and the results, equal within 1e-6."""
    cfg = load_config(preset_path("bilstm"),
                      overrides=dict(BILSTM, **{"data.n_folds": 3, "train.epoch_impl": "scan",
                                                "optim.lr": 3e-3, "train.batch_size": 8}))
    data = make_synthetic(n_windows=96, num_classes=3, sensor_dim=6, windows_per_video=8,
                          noise=0.05, seed=0)
    runs = {}
    for scan_epochs in (False, True, 2, None):
        curves = {}
        res = cross_validate_vmapped(cfg, data, epochs=4, scan_epochs=scan_epochs,
                                     metrics_factory=_recorder(curves), device="cpu")
        runs[scan_epochs] = (res, curves)
    base, base_curves = runs[False]
    assert all(len({s["val_accuracy"] for _, s in c}) > 1 for c in base_curves.values())
    for scan_epochs in (True, 2, None):
        res, curves = runs[scan_epochs]
        assert curves.keys() == base_curves.keys()
        for k in curves:
            assert [e for e, _ in curves[k]] == [1, 2, 3, 4]
            for (_, a), (_, b) in zip(curves[k], base_curves[k]):
                assert a.keys() == b.keys()
                for key in a:
                    assert a[key] == pytest.approx(b[key], abs=TOL), (k, key)
        for a, b in zip(res["folds"], base["folds"]):
            for key in a:
                assert a[key] == pytest.approx(b[key], abs=TOL)
        for key in res["summary"]:
            assert res["summary"][key] == pytest.approx(base["summary"][key], abs=TOL)


def test_fused_cv_refusals():
    cfg = load_config(preset_path("bilstm"),
                      overrides=dict(BILSTM, **{"data.n_folds": 2, "train.epoch_impl": "scan"}))
    data = make_synthetic(n_windows=48, num_classes=3, sensor_dim=6, seed=0)
    for kw in (dict(grad_norms=True), dict(step_metrics_factory=lambda k: None)):
        with pytest.raises(ValueError, match="scan_epochs=True"):
            cross_validate_vmapped(cfg, data, epochs=1, scan_epochs=True, device="cpu", **kw)
    host = cfg.replace(train=dataclasses.replace(cfg.train, epoch_impl="host"))
    with pytest.raises(ValueError, match="scan_epochs=True"):
        cross_validate_vmapped(host, data, epochs=1, scan_epochs=True, device="cpu")
