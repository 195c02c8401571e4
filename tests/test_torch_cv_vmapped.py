"""The port's fold-parallel cross-validation (``train/cv_vmapped.py``) on the
CPU at small widths: against the JAX package's ``cross_validate_vmapped``
(fold sets, result structure, epoch-1 losses and accuracies from the same
initial variables), against the port's own single-fold step, against the
sequential driver, and its own rules (the NaN gate, per-fold draws, the
fold mesh, no per-example fallback, BatchNorm under vmap).

Tolerances: epoch-1 train loss 1e-4 relative against JAX (two float32
implementations; the port's epoch is JAX's batches); accuracies within one
test window; the vmapped step against the single-fold step 1e-5 (the same
arithmetic, batched); the fold mesh 1e-6 (the same program per fold).
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from fall_multimodal_tpu.train import cv_vmapped as jax_cv_vmapped
from fall_multimodal_tpu_torch import cli
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import gather_batch, make_synthetic, to_device
from fall_multimodal_tpu_torch.interop import load_into, state_dict_from_jax_variables
from fall_multimodal_tpu_torch.models.layers import BatchNorm1d
from fall_multimodal_tpu_torch.parallel import make_mesh
from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from fall_multimodal_tpu_torch.train import cv, cv_vmapped
from fall_multimodal_tpu_torch.train.cv_vmapped import (
    cross_validate_vmapped,
    load_fold,
    make_fold_train_step,
    stack_states,
    strict_vmap,
)
from torch_port_helpers import to_numpy

torch.set_num_threads(1)

OVERRIDES = {"data.num_classes": 3, "data.n_folds": 3, "data.sensor_dim": 6,
             "model.kwargs.hidden_size": 8}
DATA = dict(n_windows=96, num_classes=3, sensor_dim=6, windows_per_video=8, noise=0.05,
            seed=0)
JAX_DATA = dict(DATA, n_windows=120)      # the JAX package's tests/test_cv_checkpoint_cli.py set
NARROW = {"model.kwargs.stages": "[[8,1,false],[8,1,true],[16,2,true]]",
          "train.batch_size": 8}
KEYS = ["fold", "val_accuracy", "test_accuracy", "macro_precision", "macro_recall",
        "macro_f1", "micro_f1"]


def _recorder(store):
    def factory(k):
        return lambda epoch, scalars: store.setdefault(k, []).append(scalars)
    return factory


@pytest.fixture(scope="module")
def against_jax():
    """Both packages' vmapped CV (bilstm, 3 folds x 6 epochs) from JAX's fold-k
    initial variables, with their epoch curves."""
    captured = {}
    jax_create = jax_cv_vmapped.create_train_state
    port_create = cv_vmapped.create_train_state

    def jax_state(*args, seed, **kw):
        captured[seed] = state = jax_create(*args, seed=seed, **kw)
        return state

    def port_state(config, optimizer, seed, **kw):
        state = port_create(config, optimizer, seed=seed, **kw)
        j = captured[seed]
        variables = {"params": j.params, "batch_stats": j.batch_stats}
        load_into(state.model, state_dict_from_jax_variables(config, variables))
        return state

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_cv_vmapped, "create_train_state", jax_state)
    mp.setattr(cv_vmapped, "create_train_state", port_state)
    try:
        jax_curves, port_curves = {}, {}
        ref = jax_cv_vmapped.cross_validate_vmapped(
            jax_load_config(jax_preset_path("bilstm"), overrides=OVERRIDES),
            jax_make_synthetic(**JAX_DATA), n_folds=3, epochs=6,
            metrics_factory=_recorder(jax_curves))
        ours = cross_validate_vmapped(load_config(preset_path("bilstm"), overrides=OVERRIDES),
                                      make_synthetic(**JAX_DATA), n_folds=3, epochs=6,
                                      metrics_factory=_recorder(port_curves), device="cpu")
    finally:
        mp.undo()
    return ours, ref, port_curves, jax_curves


def test_result_has_the_jax_structure_and_folds(against_jax):
    ours, ref, _, _ = against_jax
    assert list(ours) == list(ref) == ["folds", "summary"]
    assert [list(r) for r in ours["folds"]] == [list(r) for r in ref["folds"]] == [KEYS] * 3
    assert list(ours["summary"]) == list(ref["summary"])
    cfg = load_config(preset_path("bilstm"), overrides=OVERRIDES)
    data = make_synthetic(**JAX_DATA)
    ours_folds = cv_vmapped.fold_indices(cfg, data, 3)
    jax_folds = jax_cv_vmapped.kfold_indices(data.videos, n_folds=3, seed=cfg.seed,
                                             by_video=True)
    for a, b in zip(ours_folds, jax_folds):
        for split in ("train", "test"):
            np.testing.assert_array_equal(a[split], b[split])
    json.dumps(ours)


def test_epoch_one_losses_and_accuracies_match_jax(against_jax):
    """Epoch-1 train loss at 1e-4; every epoch's val accuracy, the best and
    the final test accuracy within one test window of JAX's."""
    ours, ref, port_curves, jax_curves = against_jax
    cfg = load_config(preset_path("bilstm"), overrides=OVERRIDES)
    folds = cv_vmapped.fold_indices(cfg, make_synthetic(**JAX_DATA), 3)
    for k, (a, b, f) in enumerate(zip(ours["folds"], ref["folds"], folds)):
        np.testing.assert_allclose(port_curves[k][0]["train_loss"],
                                   jax_curves[k][0]["train_loss"], rtol=1e-4)
        window = 1.0 / len(f["test"]) + 1e-6
        for p, j in zip(port_curves[k], jax_curves[k]):
            assert abs(p["val_accuracy"] - j["val_accuracy"]) <= window
        assert abs(a["val_accuracy"] - b["val_accuracy"]) <= window
        assert abs(a["test_accuracy"] - b["test_accuracy"]) <= window


def _fold_and_single_states(cfg, k):
    opt = build_optimizer(cfg)
    folds = stack_states([create_train_state(cfg, opt, seed=cfg.seed + i, device="cpu")
                          for i in range(k)], opt, torch.Generator().manual_seed(0))
    singles = [create_train_state(cfg, opt, seed=cfg.seed + i, device="cpu") for i in range(k)]
    return folds, singles


def _fold_norms(cfg, data, idx):
    folds, _ = _fold_and_single_states(cfg, idx.shape[0])
    _, m = make_fold_train_step(softmax_before_ce=cfg.model.softmax_output,
                                grad_norms=True)(folds, data, idx)
    return torch.stack(list(m["grad_norms"].values())).pow(2).sum(0).sqrt()


@pytest.mark.parametrize("preset,overrides,clip", [
    ("bilstm", OVERRIDES, False),
    ("bilstm", {**OVERRIDES, "optim.type": "sgd", "optim.lr": 0.05}, True),
    ("gstcan_urfall_3stream", {**NARROW, "optim.type": "sgd", "optim.lr": 0.05}, True),
])
def test_vmapped_folds_equal_the_single_fold_step(preset, overrides, clip):
    """Three steps of every fold through the vmapped step and through the
    port's single-fold step from the same init on the same rows: losses at
    1e-5 and, under SGD (whose update is proportional to the gradient, so
    a wrong clip shows), parameters at 1e-5, with ``max_norm`` between the
    folds' gradient norms so that one fold clips and another does not."""
    cfg = load_config(preset_path(preset), overrides=overrides)
    d, k, b = cfg.data, 3, cfg.train.batch_size
    data = to_device(make_synthetic(n_windows=64, num_classes=d.num_classes,
                                    sensor_dim=d.sensor_dim, seed=1), "cpu")
    rows = torch.as_tensor(np.random.default_rng(0).integers(0, 64, (3, k, b)))
    if clip:
        norms = _fold_norms(cfg, data, rows[0])
        cut = float(norms.min() + norms.max()) / 2
        assert (norms < cut).any() and (norms > cut).any()
        cfg = load_config(preset_path(preset), overrides={**overrides, "train.max_norm": cut})
    folds, singles = _fold_and_single_states(cfg, k)
    assert not clip or folds.optimizer.max_norm == cut
    step = make_fold_train_step(softmax_before_ce=cfg.model.softmax_output)
    single = make_train_step(softmax_before_ce=cfg.model.softmax_output)
    for r in rows:
        _, m = step(folds, data, r)
        for i, state in enumerate(singles):
            _, ms = single(state, gather_batch(data, r[i]))
            np.testing.assert_allclose(float(m["loss"][i]), float(ms["loss"]), rtol=1e-5)
            if clip:
                for name, p in state.model.named_parameters():
                    np.testing.assert_allclose(to_numpy(folds.params[name][i]), to_numpy(p),
                                               atol=1e-5, err_msg=name)
    assert folds.step == singles[0].step == 3


def test_load_fold_puts_a_single_state_where_the_fold_is():
    cfg = load_config(preset_path("bilstm"), overrides={**OVERRIDES, "train.accum_iter": 2})
    data = to_device(make_synthetic(**DATA), "cpu")
    folds, singles = _fold_and_single_states(cfg, 3)
    step = make_fold_train_step()
    single = make_train_step()
    rows = torch.as_tensor(np.random.default_rng(2).integers(0, 96, (3, 3, 32)))
    for r in rows:
        step(folds, data, r)
    state = load_fold(folds, 2, singles[0])
    assert state.step == 3 and state.optimizer.mini_step == folds.optimizer.mini_step == 1
    for name, t in folds.tensors().items():
        np.testing.assert_array_equal(to_numpy(state.model.state_dict()[name]), to_numpy(t[2]))
    _, m = step(folds, data, rows[0])
    _, ms = single(state, gather_batch(data, rows[0][2]))
    np.testing.assert_allclose(float(m["loss"][2]), float(ms["loss"]), rtol=1e-5)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(to_numpy(folds.params[name][2]), to_numpy(p), atol=1e-5)


def test_protocol_delta_against_the_sequential_driver_is_bounded():
    """The vmapped driver's epochs take min(fold train) // batch steps; on the
    same data and seed both drivers learn to within the JAX package's bound
    (``tests/test_cv_checkpoint_cli.py:355-372``). 20 epochs, where the JAX
    test takes 6: after 12 steps both packages' drivers are still on the
    learning cliff of this set, where the batch order alone moves a fold's
    accuracy by 0.3 (from JAX's initial variables the port's vmapped driver
    repeats the JAX package's curves there exactly)."""
    cfg = load_config(preset_path("bilstm"), overrides={"data.num_classes": 3,
                                                        "data.n_folds": 3, "data.sensor_dim": 6})
    data = make_synthetic(n_windows=120, num_classes=3, sensor_dim=6, windows_per_video=8,
                          noise=0.05, seed=0)
    seq = cv.cross_validate(cfg, data, n_folds=3, epochs=20, device="cpu")
    par = cross_validate_vmapped(cfg, data, n_folds=3, epochs=20, device="cpu")
    for metric, bound in (("test_accuracy_mean", 0.08), ("macro_f1_mean", 0.10)):
        assert abs(seq["summary"][metric] - par["summary"][metric]) <= bound, metric
    assert par["summary"]["test_accuracy_mean"] > 0.5


def test_a_nan_fold_promotes_no_best_state(monkeypatch):
    port_create = cv_vmapped.create_train_state

    def poisoned(config, optimizer, seed, **kw):
        state = port_create(config, optimizer, seed=seed, **kw)
        if seed == config.seed + 1:
            with torch.no_grad():
                state.model.fc[1].weight.fill_(float("nan"))
        return state

    monkeypatch.setattr(cv_vmapped, "create_train_state", poisoned)
    curves = {}
    cfg = load_config(preset_path("bilstm"), overrides=OVERRIDES)
    res = cross_validate_vmapped(cfg, make_synthetic(**DATA), n_folds=3, epochs=2,
                                 metrics_factory=_recorder(curves), device="cpu")
    assert all(np.isnan(c["train_loss"]) for c in curves[1])
    assert res["folds"][1]["val_accuracy"] == -1.0     # never promoted
    for k in (0, 2):
        assert np.isfinite(curves[k][-1]["train_loss"])
        assert res["folds"][k]["val_accuracy"] == max(c["val_accuracy"] for c in curves[k])


def test_folds_draw_their_own_masks_and_repeat_them_on_a_rerun():
    """Augmentation (sensor noise) under vmap(randomness="different"): three
    folds from one init on one batch take different draws; a rerun from the
    same seed repeats them."""
    cfg = load_config(preset_path("bilstm"), overrides={
        **OVERRIDES, "augment.enabled": True, "augment.sensor_noise": 0.5})
    data = to_device(make_synthetic(**DATA), "cpu")
    aug = cv_vmapped.make_augment_fn(cfg.augment, cfg.graph.layout)
    rows = torch.arange(16).repeat(3, 1)

    def losses():
        opt = build_optimizer(cfg)
        states = [create_train_state(cfg, opt, seed=0, device="cpu") for _ in range(3)]
        folds = stack_states(states, opt, torch.Generator().manual_seed(7))
        step = make_fold_train_step(augment_fn=aug)
        return torch.stack([step(folds, data, rows)[1]["loss"] for _ in range(2)])

    first, again = losses(), losses()
    assert torch.equal(first, again)
    assert len(set(first[0].tolist())) == 3


def test_fold_mesh_on_cpu_groups_equals_one_group_and_needs_divisible_folds():
    cfg = load_config(preset_path("bilstm"), overrides={**OVERRIDES, "data.n_folds": 4})
    data = make_synthetic(**DATA)
    base = cross_validate_vmapped(cfg, data, n_folds=4, epochs=2, device="cpu")
    mesh = make_mesh(2, axis="fold", device="cpu")
    assert mesh.size == 2 and mesh.group is None
    sharded = cross_validate_vmapped(cfg, data, n_folds=4, epochs=2, mesh=mesh, device="cpu")
    for a, b in zip(base["folds"], sharded["folds"]):
        for key in KEYS:
            assert a[key] == pytest.approx(b[key], abs=1e-6)
    with pytest.raises(ValueError, match="divide evenly"):
        cross_validate_vmapped(cfg, data, n_folds=3, epochs=1, mesh=mesh, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, axis="fold")


def test_scan_epochs_and_the_scan_impl_raise():
    cfg = load_config(preset_path("bilstm"), overrides=OVERRIDES)
    with pytest.raises(ValueError, match="scan_epochs"):
        cross_validate_vmapped(cfg, make_synthetic(**DATA), scan_epochs=True, device="cpu")
    scan = load_config(preset_path("bilstm"), overrides={**OVERRIDES,
                                                          "train.epoch_impl": "scan"})
    with pytest.raises(ValueError, match="epoch_impl"):
        cross_validate_vmapped(scan, make_synthetic(**DATA), device="cpu")


def test_no_op_falls_back_to_the_per_example_loop():
    """A vmapped flagship step (every layer, the BiLSTM's own rule included)
    emits no batching-rule warning with functorch's warnings on; inside
    ``strict_vmap`` an op without a batching rule raises."""
    cfg = load_config(preset_path("gstcan_urfall_3stream"), overrides=NARROW)
    data = to_device(make_synthetic(n_windows=32, num_classes=2, sensor_dim=4, seed=0), "cpu")
    folds, _ = _fold_and_single_states(cfg, 2)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            make_fold_train_step(softmax_before_ce=True)(folds, data, torch.arange(16).view(2, 8))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert not [w for w in seen if "performance drop" in str(w.message)]
    with strict_vmap(), pytest.raises(RuntimeError, match="fallback"):
        torch.func.vmap(torch.histc)(torch.rand(2, 8))
    torch.func.vmap(torch.histc)(torch.rand(2, 8))     # the setting is restored


def test_bfloat16_folds_train():
    cfg = load_config(preset_path("bilstm"), overrides={**OVERRIDES,
                                                         "train.dtype": "bfloat16"})
    res = cross_validate_vmapped(cfg, make_synthetic(**DATA), n_folds=2, epochs=1,
                                 device="cpu")
    assert all(0.0 <= r["test_accuracy"] <= 1.0 for r in res["folds"])


def test_grad_norms_stream_per_fold():
    per_fold = {0: [], 1: []}

    def factory(k):
        def cb(step, scalars):
            assert all(name.startswith("grad_norm/") for name in scalars)
            assert all(np.isfinite(v) and v >= 0 for v in scalars.values())
            per_fold[k].append(step)
        return cb

    cfg = load_config(preset_path("bilstm"), overrides=OVERRIDES)
    cross_validate_vmapped(cfg, make_synthetic(**DATA), n_folds=2, epochs=2, grad_norms=True,
                           step_metrics_factory=factory, device="cpu")
    assert per_fold[0] == per_fold[1] == sorted(per_fold[0]) and per_fold[0]


def test_batchnorm_keeps_the_biased_running_variance_under_vmap():
    torch.manual_seed(0)
    norms = [BatchNorm1d(5) for _ in range(3)]
    x = torch.randn(3, 8, 5) * torch.tensor([1.0, 2.0, 3.0])[:, None, None] + 1.0
    params, buffers = torch.func.stack_module_state(norms)
    base = BatchNorm1d(5)
    with strict_vmap():
        y = torch.func.vmap(lambda p, b, x: torch.func.functional_call(base, (p, b), (x,)))(
            params, buffers, x)
    for k, bn in enumerate(norms):
        np.testing.assert_allclose(to_numpy(y[k]), to_numpy(bn(x[k])), atol=1e-6)
        biased = x[k].var(0, unbiased=False)
        np.testing.assert_allclose(to_numpy(buffers["running_var"][k]),
                                   to_numpy(0.9 + 0.1 * biased), rtol=1e-6)
        np.testing.assert_allclose(to_numpy(buffers["running_var"][k]),
                                   to_numpy(bn.running_var), rtol=1e-6)
    assert buffers["num_batches_tracked"].tolist() == [1, 1, 1]


def test_the_fold_batched_lstm_matches_nn_lstm_in_and_out_of_vmap():
    from fall_multimodal_tpu_torch.models.layers import BiLSTMLayer, _FoldBatchedBiLSTM

    torch.manual_seed(0)
    layers = [BiLSTMLayer(4, 6) for _ in range(2)]
    x = torch.randn(2, 5, 7, 4, requires_grad=True)
    params, _ = torch.func.stack_module_state(layers)
    base = BiLSTMLayer(4, 6)
    with strict_vmap():
        y = torch.func.vmap(lambda p, x: torch.func.functional_call(base, p, (x,)))(params, x)
    y.square().sum().backward()
    for k, layer in enumerate(layers):
        xk = x[k].detach().requires_grad_()
        ref = layer(xk)
        ref.square().sum().backward()
        np.testing.assert_allclose(to_numpy(y[k]), to_numpy(ref), atol=1e-6)
        np.testing.assert_allclose(to_numpy(x.grad[k]), to_numpy(xk.grad), atol=1e-6)
        for name, p in layer.named_parameters():
            np.testing.assert_allclose(to_numpy(params[name].grad[k]), to_numpy(p.grad),
                                       atol=1e-5, err_msg=name)
    # outside vmap the Function recomputes in its backward
    small = BiLSTMLayer(2, 3)
    weights = [w.detach().double().requires_grad_() for w in small._flat_weights]
    xd = torch.randn(2, 4, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, *w: _FoldBatchedBiLSTM.apply(x, *w),
                                    (xd, *weights), eps=1e-6, atol=1e-5)


# ---------------------------------------------------------------- CLI

def test_cli_cv_vmapped_writes_jax_shaped_results(tmp_path, against_jax):
    """The JAX CLI writes ``cross_validate_vmapped``'s result as it is
    (``cli.py:340-367``), so the port's file is held against that result."""
    _, ref, _, _ = against_jax
    ours = cli.main(["--config", "bilstm", "--cv-vmapped", "--folds", "3", "--epochs", "1",
                     "--set", "data.num_classes=3", "--synthetic-windows", "96",
                     "--device", "cpu", "--output-dir", str(tmp_path)])
    with open(tmp_path / "cv_results.json") as fh:
        written = json.load(fh)
    assert written == json.loads(json.dumps(ours))
    assert [list(r) for r in written["folds"]] == [list(r) for r in ref["folds"]]
    assert list(written["summary"]) == list(ref["summary"])
    assert not os.path.exists(tmp_path / "ckpt")


def test_cli_cv_vmapped_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", "bilstm", "--cv-vmapped", "--folds", "3",
                  "--output-dir", str(tmp_path)])
