"""The port's training substrate against the JAX package's, on the CPU:
losses, metrics, optimizers and schedules, weight init, the BatchNorm's
running statistics, gradient telemetry.

Tolerances: losses 1e-6 relative; optimizers 1e-6 absolute after 5 steps
on the same gradients (the same float32 update in another library);
schedules 1e-6 relative (the JAX package evaluates them in float32, the
port in float64); running statistics 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fall_multimodal_tpu.configs import OptimConfig as JaxOptimConfig
from fall_multimodal_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from fall_multimodal_tpu.models.layers import BatchNorm as JaxBatchNorm
from fall_multimodal_tpu.train import build_optimizer as jax_build_optimizer
from fall_multimodal_tpu.train import build_schedule as jax_build_schedule
from fall_multimodal_tpu.train import losses as jax_losses
from fall_multimodal_tpu.train import metrics as jax_metrics
from fall_multimodal_tpu_torch.configs import OptimConfig, SchedulerConfig, load_config, preset_path
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.models.init import SCHEMES, reinitialize
from fall_multimodal_tpu_torch.models.layers import BatchNorm, BatchNorm1d
from fall_multimodal_tpu_torch.train import (
    build_optimizer,
    build_schedule,
    classification_report,
    confusion_matrix,
    create_train_state,
    cross_entropy,
    param_count,
    prf_from_confusion,
    smooth_labels,
    top_k_accuracy,
)
from fall_multimodal_tpu_torch.train.losses import cross_entropy_per_sample
from fall_multimodal_tpu_torch.utils.profiling import global_norm, grad_norms
from torch_port_helpers import t, to_numpy

torch.set_num_threads(1)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("softmax_before_ce", [False, True])
@pytest.mark.parametrize("target_kind", ["soft", "index"])
def test_cross_entropy_matches_jax(rng, smoothing, softmax_before_ce, target_kind):
    logits = rng.normal(size=(16, 5)).astype(np.float32) * 3
    if target_kind == "soft":
        target = rng.dirichlet(np.ones(5), size=16).astype(np.float32)
    else:
        target = rng.integers(0, 5, size=16)
    ref = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(target),
                                   label_smoothing=smoothing,
                                   softmax_before_ce=softmax_before_ce)
    ours = cross_entropy(torch.as_tensor(logits), torch.as_tensor(target),
                         label_smoothing=smoothing, softmax_before_ce=softmax_before_ce)
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)
    per = cross_entropy_per_sample(torch.as_tensor(logits), torch.as_tensor(target),
                                   smoothing, softmax_before_ce)
    assert per.shape == (16,) and float(per.mean()) == pytest.approx(float(ours), rel=1e-6)


def test_smooth_labels_matches_jax():
    y = np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(to_numpy(smooth_labels(t(y), 0.1)),
                               np.asarray(jax_losses.smooth_labels(jnp.asarray(y), 0.1)),
                               atol=1e-7)
    assert smooth_labels(t(y), 0.0) is not None


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("top_k", [(1,), (1, 2), (1, 3, 5)])
def test_top_k_matches_jax(rng, top_k):
    logits = np.round(rng.normal(size=(64, 6)), 1).astype(np.float32)   # with ties
    soft = rng.dirichlet(np.ones(6), size=64).astype(np.float32)
    for target in (soft, soft.argmax(-1)):
        ref = jax_metrics.top_k_accuracy(jnp.asarray(logits), jnp.asarray(target), top_k)
        ours = top_k_accuracy(torch.as_tensor(logits), torch.as_tensor(target), top_k)
        np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=1e-7)


def test_confusion_prf_and_report_match_jax(rng):
    logits = rng.normal(size=(200, 4)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 3, size=200)]   # class 3 absent
    ref_cm = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(logits), jnp.asarray(labels), 4))
    cm = to_numpy(confusion_matrix(torch.as_tensor(logits), torch.as_tensor(labels), 4))
    np.testing.assert_array_equal(cm, ref_cm)
    pred = logits.argmax(-1)
    np.testing.assert_array_equal(
        to_numpy(confusion_matrix(torch.as_tensor(pred), torch.as_tensor(labels), 4)), ref_cm)
    ref = jax_metrics.prf_from_confusion(jnp.asarray(ref_cm))
    ours = prf_from_confusion(cm)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(to_numpy(ours[k]), np.asarray(ref[k]), atol=1e-6, err_msg=k)
    assert classification_report(cm, list("abcd")) == \
        jax_metrics.classification_report(ref_cm, list("abcd"))


def test_save_confusion_png_writes_a_file_or_names_matplotlib(tmp_path):
    from fall_multimodal_tpu_torch.train import save_confusion_png

    try:
        path = save_confusion_png(np.array([[3, 1], [0, 4]]), str(tmp_path / "cm.png"))
    except ImportError:
        pytest.skip("matplotlib is not installed")
    assert (tmp_path / "cm.png").stat().st_size > 0 and path.endswith("cm.png")


# ------------------------------------------------------------- optimizers

def _run_both(rng, jax_opt, opt, steps=5, shapes=((7, 3), (5,)), scale=1.0):
    """The same gradient sequence through an optax transformation and the
    port's Optimizer; returns both parameter sets."""
    w0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params = {f"w{i}": jnp.asarray(w) for i, w in enumerate(w0)}
    jstate = jax_opt.init(params)
    ours = [torch.nn.Parameter(torch.tensor(w)) for w in w0]
    bound = opt.init(ours)
    for _ in range(steps):
        grads = [scale * rng.normal(size=s).astype(np.float32) for s in shapes]
        updates, jstate = jax_opt.update({f"w{i}": jnp.asarray(g) for i, g in enumerate(grads)},
                                         jstate, params)
        params = optax.apply_updates(params, updates)
        bound.zero_grad()
        for p, g in zip(ours, grads):
            p.grad = torch.tensor(g)
        bound.step()
    return [np.asarray(params[f"w{i}"]) for i in range(len(shapes))], \
        [to_numpy(p) for p in ours], bound


@pytest.mark.parametrize("kind,momentum,wd", [
    ("sgd", 0.0, 0.0), ("sgd", 0.9, 0.01), ("adam", 0.0, 0.0), ("adam", 0.0, 0.01),
    ("adamw", 0.0, 0.01), ("rmsprop", 0.0, 0.0), ("rmsprop", 0.0, 0.05)])
def test_optimizers_match_optax(rng, kind, momentum, wd):
    """Five steps on the same gradients; rmsprop is the JAX package's
    ``scale_by_torch_rms`` against ``torch.optim.RMSprop``."""
    kw = dict(type=kind, lr=1e-3, momentum=momentum, weight_decay=wd)
    ref, ours, _ = _run_both(rng, jax_build_optimizer(JaxOptimConfig(**kw)),
                             build_optimizer(OptimConfig(**kw)))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clipping_below_and_above_max_norm(rng, scale):
    """optax's rule: scaled by max_norm / norm only above max_norm."""
    kw = dict(type="sgd", lr=0.5)
    ref, ours, _ = _run_both(
        rng, jax_build_optimizer(JaxOptimConfig(**kw), max_norm=1.0),
        build_optimizer(OptimConfig(**kw), max_norm=1.0), steps=3, scale=scale)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_clipping_scales_to_max_norm_exactly():
    opt = build_optimizer(OptimConfig(type="sgd", lr=1.0), max_norm=2.0)
    p = torch.nn.Parameter(torch.zeros(4))
    bound = opt.init([p])
    p.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])           # norm 5 -> 2
    bound.step()
    np.testing.assert_allclose(to_numpy(p), [-1.2, -1.6, 0, 0], atol=1e-7)


def test_accumulation_matches_optax_multisteps(rng):
    kw = dict(type="rmsprop", lr=1e-3)
    sched = dict(type="cosine", t_initial=4, warmup_t=1)
    ref, ours, bound = _run_both(
        rng,
        jax_build_optimizer(JaxOptimConfig(**kw), JaxSchedulerConfig(**sched),
                            steps_per_epoch=4, max_norm=1.0, accum_iter=3),
        build_optimizer(OptimConfig(**kw), SchedulerConfig(**sched), steps_per_epoch=4,
                        max_norm=1.0, accum_iter=3), steps=10)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert (bound.gradient_step, bound.mini_step) == (3, 1)


def test_schedule_pacing_under_grad_accum():
    """The schedule advances per gradient step: per data epoch of 4
    micro-steps, 2 updates at that epoch's lr (as the JAX package's test)."""
    opt = build_optimizer(OptimConfig(type="sgd", lr=1.0),
                          SchedulerConfig(type="multistep", decay_steps=(1, 2),
                                          decay_rate=0.1, warmup_t=0),
                          steps_per_epoch=4, accum_iter=2)
    p = torch.nn.Parameter(torch.zeros(()))
    bound = opt.init([p])
    applied, before = [], 0.0
    for _ in range(12):
        p.grad = torch.ones(())
        if bound.step():
            applied.append(before - float(p.detach()))
        before = float(p.detach())
    assert applied == pytest.approx([1.0, 1.0, 0.1, 0.1, 0.01, 0.01])


@pytest.mark.parametrize("sched", [
    dict(type="cosine", t_initial=2, warmup_t=1, lr_min=1e-5, warmup_lr_init=1e-4),
    dict(type="cosine", t_initial=3, warmup_t=0),
    dict(type="step", t_initial=1, decay_rate=0.5, warmup_t=1),
    dict(type="step", t_initial=2, decay_rate=0.1, warmup_t=0),
    dict(type="multistep", decay_steps=(1, 2), decay_rate=0.1, warmup_t=0),
    dict(type="multistep", decay_steps=(2,), decay_rate=0.3, warmup_t=1),
])
def test_schedules_match_jax_every_step_of_three_epochs(sched):
    steps_per_epoch = 7
    ref = jax_build_schedule(JaxSchedulerConfig(**sched), 1e-3, steps_per_epoch)
    ours = build_schedule(SchedulerConfig(**sched), 1e-3, steps_per_epoch)
    for step in range(3 * steps_per_epoch):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6), step
    assert build_schedule(SchedulerConfig(), 1e-3) == 1e-3


def test_unknown_optimizer_and_schedule_raise():
    with pytest.raises(ValueError, match="optimizer type"):
        build_optimizer(OptimConfig(type="lamb"))
    with pytest.raises(ValueError, match="scheduler type"):
        build_schedule(SchedulerConfig(type="poly"), 1e-3)
    with pytest.raises(RuntimeError, match="unbound"):
        build_optimizer(OptimConfig()).step()


def test_optimizer_state_round_trips(rng):
    opt = build_optimizer(OptimConfig(type="adam", lr=1e-2), max_norm=1.0, accum_iter=2)
    p = torch.nn.Parameter(torch.tensor(rng.normal(size=5).astype(np.float32)))
    a = opt.init([p])
    for _ in range(3):
        p.grad = torch.tensor(rng.normal(size=5).astype(np.float32))
        a.step()
    q = torch.nn.Parameter(p.detach().clone())
    b = opt.init([q])
    b.load_state_dict(copy.deepcopy(a.state_dict()))     # as a file would hand it over
    g = torch.tensor(rng.normal(size=5).astype(np.float32))
    p.grad, q.grad = g.clone(), g.clone()
    a.step()
    b.step()
    np.testing.assert_array_equal(to_numpy(p), to_numpy(q))


# --------------------------------------------------------------------- init

def _model(scheme, seed=0):
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    return reinitialize(build_model(cfg), seed=seed, scheme=scheme).requires_grad_(False)


@pytest.fixture(scope="module")
def schemes():
    return {s: _model(s) for s in SCHEMES}


def test_torch_scheme_bounds_and_spread(schemes):
    m = schemes["torch"]
    w = m.pts_stream.st_gcn_networks[6].tcn[2].weight           # (256, 256, 9, 1)
    bound = 1 / np.sqrt(256 * 9)
    assert float(w.abs().max()) <= bound
    assert float(w.std()) == pytest.approx(bound / np.sqrt(3), rel=0.02)
    b = m.pts_stream.st_gcn_networks[6].tcn[2].bias
    assert float(b.abs().max()) <= bound
    g = m.pts_stream.st_gcn_networks[6].gcn.conv.weight          # 1x1, fan_in 256
    assert float(g.std()) == pytest.approx(1 / np.sqrt(256) / np.sqrt(3), rel=0.02)
    lstm = m.sensor.bilstm.lstm1
    for name, p in lstm.named_parameters():
        assert float(p.abs().max()) <= 1 / np.sqrt(64), name
        assert float(p.std()) == pytest.approx(1 / 8 / np.sqrt(3), rel=0.1), name


def test_init_param_scheme(schemes):
    m = schemes["init_param"]
    conv = m.pts_stream.st_gcn_networks[6].tcn[2]
    assert float(conv.weight.std()) == pytest.approx(np.sqrt(2 / (256 * 9)), rel=0.02)
    assert float(conv.bias.abs().max()) == 0.0
    # a 1x1 channel mix is a flax Dense in the JAX package: linear, std 1e-3
    assert float(m.pts_stream.st_gcn_networks[6].gcn.conv.weight.std()) == \
        pytest.approx(1e-3, rel=0.02)
    assert float(m.fcn.weight.std()) == pytest.approx(1e-3, rel=0.1)
    assert float(m.sensor.bilstm.lstm1.weight_ih_l0.abs().max()) <= 1 / 8


def test_flax_scheme_is_lecun_normal(schemes):
    m = schemes["flax"]
    w = m.pts_stream.st_gcn_networks[6].tcn[2].weight
    std = 1 / np.sqrt(256 * 9)
    assert float(w.std()) == pytest.approx(std, rel=0.02)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(m.pts_stream.st_gcn_networks[6].tcn[2].bias.abs().max()) == 0.0
    ih = m.sensor.bilstm.lstm1.weight_ih_l0                      # (256, 32): fan_in 32
    assert float(ih.std()) == pytest.approx(1 / np.sqrt(32), rel=0.05)
    assert float(m.sensor.bilstm.lstm1.bias_ih_l0.abs().max()) == 0.0


def test_norms_and_edge_importance_are_left_alone(schemes):
    for m in schemes.values():
        bn = m.pts_stream.st_gcn_networks[3].tcn[0]
        assert float(bn.weight.min()) == float(bn.weight.max()) == 1.0
        assert float(bn.bias.abs().max()) == 0.0
        assert float(m.pts_stream.edge_importance[2].min()) == 1.0


def test_init_is_seeded_and_order_independent():
    a, b, c = _model("torch", 3), _model("torch", 3), _model("torch", 4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert not torch.equal(sa["fcn.weight"], sc["fcn.weight"])
    # a parameter's draw depends on its name only, not on the others: the
    # two-stream model with a BiLSTM sensor head has other parameters before
    # its fusion head than the flagship (CNN+BiLSTM), and draws it the same
    other = reinitialize(build_model(load_config(preset_path("two_stgcan_bilstm_urfall"))),
                         seed=3, scheme="torch").state_dict()
    assert "sensor.cnn.layer1.0.weight" in sa and "sensor.cnn.layer1.0.weight" not in other
    for k in ("fcn.weight", "fcn.bias", "mot_stream.st_gcn_networks.6.tcn.2.weight"):
        assert torch.equal(other[k], sa[k]), k
    with pytest.raises(ValueError, match="weight_init scheme"):
        reinitialize(a, 0, "xavier")


def test_create_train_state_and_param_count():
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    state = create_train_state(cfg, build_optimizer(cfg), seed=1, device="cpu")
    assert state.step == 0 and state.device.type == "cpu"
    total = param_count(state)
    assert total == sum(p.numel() for p in state.model.parameters())
    assert param_count(state, exclude="fcn") == total - 514 * 2 - 2
    snap = state.snapshot()
    with torch.no_grad():
        state.model.fcn.weight.add_(1.0)
    assert not torch.equal(snap.model.fcn.weight, state.model.fcn.weight)
    assert snap.optimizer.params[0] is next(snap.model.parameters())


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("shape", [(4, 6), (32, 5), (8, 30, 14)])
def test_batchnorm_running_statistics_match_flax(rng, shape):
    """After train-mode forwards the running mean/var are flax's: biased
    batch variance, momentum 0.1 (stock torch keeps the unbiased one)."""
    module = JaxBatchNorm()
    x0 = jnp.zeros(shape)
    variables = module.init(jax.random.key(0), x0, train=False)
    ours = BatchNorm(shape[-1]).train()
    for _ in range(3):
        x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
        y_ref, mutated = module.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        y = ours(t(x))
        np.testing.assert_allclose(to_numpy(y), np.asarray(y_ref), atol=2e-5)
    stats = variables["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(to_numpy(ours.running_mean), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(to_numpy(ours.running_var), np.asarray(stats["var"]), atol=1e-6)
    unbiased = torch.nn.BatchNorm1d(shape[-1]).train()
    unbiased(t(x).reshape(-1, shape[-1]))
    assert not torch.allclose(unbiased.running_var, ours.running_var)


def test_channel_first_batchnorm_matches_flax_over_time(rng):
    """The sensor CNN's BatchNorm1d on (N, C, L) takes statistics over N
    and L, as flax's BatchNorm over a channel-last (N, L, C) tensor."""
    x = rng.normal(size=(6, 5, 11)).astype(np.float32)
    module = JaxBatchNorm()
    variables = module.init(jax.random.key(0), jnp.zeros((6, 11, 5)), train=False)
    _, mutated = module.apply(variables, jnp.asarray(x.transpose(0, 2, 1)), train=True,
                              mutable=["batch_stats"])
    bn = BatchNorm1d(5).train()
    bn(t(x))
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(to_numpy(bn.running_var), np.asarray(stats["var"]), atol=1e-6)
    np.testing.assert_allclose(to_numpy(bn.running_mean), np.asarray(stats["mean"]), atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    np.testing.assert_allclose(
        to_numpy(bn(t(x))),
        to_numpy(torch.nn.functional.batch_norm(t(x), bn.running_mean, bn.running_var,
                                                bn.weight, bn.bias, False, 0.0, bn.eps)),
        atol=1e-7)


# ---------------------------------------------------------------- telemetry

def test_global_norm_and_grad_norms():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    model(torch.ones(4, 3)).sum().backward()
    norms = grad_norms(model)
    assert set(norms) == {"0.weight", "0.bias", "1.weight", "1.bias"}
    total = float(global_norm(p.grad for p in model.parameters()))
    assert total == pytest.approx(float(np.sqrt(sum(float(v) ** 2 for v in norms.values()))),
                                  rel=1e-6)
