"""The port's training path against the JAX package's, on the CPU.

The same seeded flax variables are carried into the port
(``interop.state_dict_from_jax_variables``), the same numpy-made batches and
index matrices go through both trainers, and the JAX gradients, which have
the params' tree, are carried across by the same converter (same
transposes). Tolerances (two float32 CPU implementations summing in
different orders): loss 1e-5 relative and absolute; batch statistics and
parameters after a step 1e-5 absolute; epoch losses 1e-4;
confusion matrices identical.

Logits and gradients are held against the same step evaluated in float64
(the port's modules cast to double): the port's float32 values at 1e-5, the
JAX package's at 1e-4 (for gradients plus 1e-4, respectively 1e-2, of the
tensor's largest element). The JAX package's own float32 error is the larger:
flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2, which cancels
where a channel's mean is large against its spread (the pose score channel,
mean 0.85, spread 0.09), and its gradients sit up to 1e-4 from float64 on
these inputs (the data BN's scale) where the port's sit under 2e-6.

The eval loss after two epochs is compared at 5e-2 only: eval reads the
running statistics and the BN-cancelled biases, which the two packages move
with unrelated signs; the confusion matrices must still be equal.

Biases that a BatchNorm cancels: the temporal conv's (``tcn.2.bias``,
before ``tcn.3``), the residual projection's (``residual.0.bias``, before
``residual.1``), the SE squeeze's (``channel_attention_module.atten.1.bias``,
before ``atten.2``) and the sensor CNN's (``sensor.cnn.layer{1,2}.0.bias``,
before their BatchNorm1d). Their gradient is exactly 0 in exact arithmetic
and float noise in both frameworks, and RMSprop's first update,
``lr*g/(sqrt(0.01*g^2)+eps)``, is ``+-0.01`` whatever the noise's size. So
JAX and the port move them by 0.01 with unrelated signs. They are held by
what they change: nothing in a train-mode forward, and, once the JAX values
are carried over, the eval logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.data.pipeline import DeviceData as JaxDeviceData
from fall_multimodal_tpu.interop import torch_to_variables
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.train import build_optimizer as jax_build_optimizer
from fall_multimodal_tpu.train import make_eval_epoch as jax_make_eval_epoch
from fall_multimodal_tpu.train import make_train_epoch as jax_make_train_epoch
from fall_multimodal_tpu.train.losses import cross_entropy as jax_cross_entropy
from fall_multimodal_tpu.train.state import TrainState as JaxTrainState
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import make_synthetic
from fall_multimodal_tpu_torch.data.pipeline import DeviceData, eval_batch_indices, eval_batch_mask
from fall_multimodal_tpu_torch.interop import load_into, state_dict_from_jax_variables
from fall_multimodal_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    cross_entropy,
    make_eval_epoch,
    make_train_epoch,
    make_train_step,
)
from torch_port_helpers import random_init, t, to_numpy

torch.set_num_threads(1)

TINY = ((16, 1, False), (16, 1, True), (32, 2, True))
BATCH = 8
TOL = 1e-5
LR = 1e-3 * 10     # RMSprop's first step: lr * g / sqrt(0.01 * g^2)
BN_CANCELLED = ("tcn.2.bias", "residual.0.bias", "channel_attention_module.atten.1.bias",
                "cnn.layer1.0.bias", "cnn.layer2.0.bias")


def bn_cancelled(name):
    return name.endswith(BN_CANCELLED)


def _configs(preset, tiny):
    out = []
    for load, path in ((jax_load_config, jax_preset_path), (load_config, preset_path)):
        cfg = load(path(preset))
        kwargs = dict(cfg.model.kwargs, **({"stages": TINY} if tiny else {}))
        out.append(cfg.replace(model=dataclasses.replace(cfg.model, kwargs=kwargs)))
    return out


class Carried:
    """One preset in both packages with the same seeded weights and data."""

    def __init__(self, preset, tiny=True, n=48, seed=5):
        self.jcfg, self.cfg = _configs(preset, tiny)
        rng = np.random.default_rng(seed)
        d = self.cfg.data
        data = make_synthetic(n_windows=n, num_classes=d.num_classes,
                              sensor_dim=d.sensor_dim, windows_per_video=4, seed=seed)
        self.skel, self.labels = data.features, data.labels
        self.sensor = (data.sensors if data.sensors is not None
                       else np.zeros((n, 1, 1), np.float32))
        self.jmodel = jax_build_model(self.jcfg)
        self.variables = random_init(self.jmodel, rng, jnp.asarray(self.skel[:2]),
                                     jnp.asarray(self.sensor[:2]), train=False)
        self.sd = state_dict_from_jax_variables(self.cfg, self.variables)
        self.rng = rng

    def jax_data(self):
        return JaxDeviceData(jnp.asarray(self.skel), jnp.asarray(self.labels),
                             jnp.asarray(self.sensor))

    def port_data(self):
        return DeviceData(t(self.skel), t(self.labels), t(self.sensor))

    def jax_state(self):
        optimizer = jax_build_optimizer(self.jcfg)
        params = jax.tree.map(jnp.asarray, self.variables["params"])
        stats = jax.tree.map(jnp.asarray, self.variables["batch_stats"])
        state = JaxTrainState(params=params, batch_stats=stats,
                              opt_state=optimizer.init(params),
                              step=jnp.zeros((), jnp.int32), rng=jax.random.key(0))
        return optimizer, state

    def port_state(self):
        state = create_train_state(self.cfg, build_optimizer(self.cfg), seed=0, device="cpu")
        load_into(state.model, self.sd)
        return state

    def to_port(self, params, batch_stats):
        """A flax (params, batch_stats) pair as the port's state_dict."""
        host = jax.device_get({"params": params, "batch_stats": batch_stats})
        return state_dict_from_jax_variables(self.cfg, host)


def jax_grads_fn(c):
    """Jitted (loss, logits, grads) of the JAX package's train-mode loss
    (``train/loop.py:93-118``) for carried model ``c``."""
    softmax = c.cfg.model.softmax_output

    @jax.jit
    def fn(params, batch_stats, batch):
        def loss_fn(p):
            out, _ = c.jmodel.apply({"params": p, "batch_stats": batch_stats},
                                    batch.features, batch.sensors, train=True,
                                    mutable=["batch_stats"])
            return jax_cross_entropy(out, batch.labels, softmax_before_ce=softmax), out

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return fn


def float64_step(state, batch, softmax_before_ce):
    """Train-mode logits and loss gradients of a float64 copy of the state's
    model."""
    model = state.snapshot().model.double().train()
    out = model(batch.features.double(), batch.sensors.double())
    cross_entropy(out, batch.labels.double(), softmax_before_ce=softmax_before_ce).backward()
    return to_numpy(out), {name: to_numpy(p.grad) for name, p in model.named_parameters()}


def one_step(c, jepoch, idx):
    """One train step on batch ``idx`` in both packages: the JAX package's
    own epoch function over a one-row index matrix, and the port's step."""
    optimizer, jstate = c.jax_state()
    jb = JaxDeviceData(*(jnp.asarray(x[idx]) for x in (c.skel, c.labels, c.sensor)))
    (jloss, jlogits), jgrads = jax_grads_fn(c)(jstate.params, jstate.batch_stats, jb)
    jnew, jmetrics = jepoch(jstate, c.jax_data(), jnp.asarray(idx[None]))

    state = c.port_state()
    batch = DeviceData(t(c.skel[idx]), t(c.labels[idx]), t(c.sensor[idx]))
    with torch.no_grad():
        logits = state.snapshot().model.train()(batch.features, batch.sensors)
    logits64, grads64 = float64_step(state, batch, c.cfg.model.softmax_output)
    _, metrics = make_train_step(softmax_before_ce=c.cfg.model.softmax_output)(state, batch)
    # the JAX package's update rule (clip + RMSprop) applied to the port's gradients
    ours = dict(c.sd, **{k: to_numpy(p.grad) for k, p in state.model.named_parameters()})
    gtree = torch_to_variables(c.jcfg, ours)["params"]
    apply = jax.jit(lambda g, st, p: optax.apply_updates(p, optimizer.update(g, st, p)[0]))
    jrule = c.to_port(apply(gtree, jstate.opt_state, jstate.params), jstate.batch_stats)
    return dict(jloss=float(jloss), jlogits=np.asarray(jlogits), grads64=grads64, jrule=jrule,
                logits64=logits64,
                jgrads=c.to_port(jgrads, jstate.batch_stats), jstate=jnew,
                jnew=c.to_port(jnew.params, jnew.batch_stats), jmetrics=jmetrics,
                state=state, logits=to_numpy(logits), metrics=metrics, batch=batch)


def jax_epochs(c):
    optimizer, _ = c.jax_state()
    softmax = c.cfg.model.softmax_output
    return (jax_make_train_epoch(c.jmodel, optimizer, softmax_before_ce=softmax, impl="host"),
            jax_make_eval_epoch(c.jmodel, c.cfg.data.num_classes, softmax_before_ce=softmax))


@pytest.fixture(scope="module")
def flagship():
    c = Carried("gstcan_urfall_3stream")
    c.jepoch, c.jeval = jax_epochs(c)
    return c


@pytest.fixture(scope="module")
def flagship_step(flagship):
    """One train step of the tiny flagship in both packages on batch 0."""
    return one_step(flagship, flagship.jepoch, np.arange(BATCH))


def check_loss_and_logits(s):
    np.testing.assert_allclose(float(s["metrics"]["loss"]), s["jloss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(s["metrics"]["loss"]), float(s["jmetrics"]["loss"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s["logits"], s["logits64"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s["jlogits"], s["logits64"], rtol=TOL, atol=10 * TOL)
    assert float(s["metrics"]["accuracy"]) == float(s["jmetrics"]["accuracy"])


def test_one_step_loss_and_logits_match(flagship_step):
    check_loss_and_logits(flagship_step)


def check_gradients(s):
    """Every gradient against float64; a BN-cancelled bias's is float noise
    around an exact 0 in both packages, held under 10 * TOL."""
    names = [name for name, _ in s["state"].model.named_parameters()]
    for name, p in s["state"].model.named_parameters():
        g64 = s["grads64"][name]
        if bn_cancelled(name):
            assert np.abs(g64).max() < 1e-12, name
            assert np.abs(to_numpy(p.grad)).max() < 10 * TOL, name
            assert np.abs(s["jgrads"][name]).max() < 10 * TOL, name
            continue
        np.testing.assert_allclose(to_numpy(p.grad), g64,
                                   atol=TOL + 1e-4 * np.abs(g64).max(), err_msg=name)
        np.testing.assert_allclose(s["jgrads"][name], g64,
                                   atol=10 * TOL + 1e-2 * np.abs(g64).max(), err_msg=name)
    return names


def check_parameters(s):
    """Parameters after the step. Every one against the JAX package's update
    rule (clip, RMSprop) applied to the port's own gradients, at 1e-6; and
    against the JAX package's own step at TOL, except the BN-cancelled
    biases (both moved by at most lr) and the elements whose float64
    gradient is nonzero and under 1e-4: there RMSprop's step
    ``lr*g/(0.1|g|+1e-8)`` is no longer +-lr and follows the JAX package's
    own gradient error."""
    cancelled, compared, total = [], 0, 0
    for name, p in s["state"].model.named_parameters():
        ours = to_numpy(p)
        np.testing.assert_allclose(ours, s["jrule"][name], atol=1e-6, err_msg=name)
        step = np.abs(ours - s["before"][name])
        assert step.max() <= LR * (1 + 1e-4), name
        if bn_cancelled(name):
            cancelled.append(name)
            assert np.abs(s["jnew"][name] - s["before"][name]).max() <= LR * (1 + 1e-4), name
            continue
        g64 = s["grads64"][name]
        steep = (np.abs(g64) >= 1e-4) | (g64 == 0)
        np.testing.assert_allclose(ours[steep], s["jnew"][name][steep], atol=TOL, err_msg=name)
        compared, total = compared + steep.sum(), total + steep.size
    assert compared > 0.6 * total        # 75% of the elements on this batch
    return cancelled


def test_one_step_gradients_match(flagship_step):
    names = check_gradients(flagship_step)
    assert len(names) == len(list(flagship_step["state"].model.parameters())) > 100


def test_one_step_batch_statistics_match(flagship_step):
    s = flagship_step
    n = 0
    for name, buf in s["state"].model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(to_numpy(buf), s["jnew"][name], atol=TOL, err_msg=name)
            n += 1
    # 2 streams x (data_bn + 3 blocks x 3 + one residual BN) + 2 CNN + 1 BiLSTM head
    assert n == 2 * 2 * (1 + 9 + 1) + 2 * 3


def test_one_step_parameters_match_except_bn_cancelled_biases(flagship, flagship_step):
    s = dict(flagship_step, before=flagship.sd)
    cancelled = check_parameters(s)
    # 2 streams x (3 tcn.2 + 3 atten.1 + 1 residual.0) + 2 sensor CNN layers
    assert len(cancelled) == 2 * 7 + 2


def test_bn_cancelled_biases_change_only_what_running_statistics_see(flagship, flagship_step):
    """The BN-cancelled biases change nothing in a train-mode forward and do
    change the eval logits; with the JAX package's stepped parameters
    carried in, the port's stepped model (its own running statistics) gives
    the JAX package's eval logits."""
    c, s = flagship, flagship_step
    params = [k for k, _ in s["state"].model.named_parameters()]
    x = (t(c.skel[BATCH:2 * BATCH]), t(c.sensor[BATCH:2 * BATCH]))
    ours, swapped, carried = (s["state"].snapshot().model for _ in range(3))
    swapped.load_state_dict({k: torch.tensor(s["jnew"][k]) for k in params
                             if bn_cancelled(k)}, strict=False)
    carried.load_state_dict({k: torch.tensor(s["jnew"][k]) for k in params}, strict=False)
    jstate = s["jstate"]
    ref = np.asarray(jax.jit(lambda v, a, b: c.jmodel.apply(v, a, b, train=False))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(c.skel[BATCH:2 * BATCH]), jnp.asarray(c.sensor[BATCH:2 * BATCH])))
    with torch.no_grad():
        np.testing.assert_allclose(to_numpy(carried.eval()(*x)), ref, rtol=TOL, atol=TOL)
        eval_swapped, eval_ours = swapped.eval()(*x), ours.eval()(*x)
        train_swapped, train_ours = swapped.train()(*x), ours.train()(*x)
    assert (eval_swapped - eval_ours).abs().max() > 10 * TOL
    np.testing.assert_allclose(to_numpy(train_swapped), to_numpy(train_ours), rtol=TOL, atol=TOL)


def test_two_epochs_match(flagship):
    """Two epochs through each package's epoch functions on the same index
    matrices: the epoch losses at 1e-4 and the eval confusion matrices."""
    c = flagship
    _, jstate = c.jax_state()
    state = c.port_state()
    softmax, k = c.cfg.model.softmax_output, c.cfg.data.num_classes
    epoch = make_train_epoch(softmax_before_ce=softmax)
    evaluate_port = make_eval_epoch(k, softmax_before_ce=softmax)
    jdata, data = c.jax_data(), c.port_data()
    n = len(c.skel)
    eidx, emask = eval_batch_indices(n, BATCH), eval_batch_mask(n, BATCH)
    rng = np.random.default_rng(11)
    for _ in range(2):
        idx = rng.permutation(n)[: n // BATCH * BATCH].reshape(-1, BATCH)
        jstate, jm = c.jepoch(jstate, jdata, jnp.asarray(idx))
        state, m = epoch(state, data, idx)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        jcm, jloss = c.jeval(jstate, jdata, jnp.asarray(eidx), jnp.asarray(emask, jnp.float32))
        cm, loss = evaluate_port(state, data, eidx, emask)
        np.testing.assert_array_equal(to_numpy(cm), np.asarray(jcm))
        # eval reads the running statistics and the BN-cancelled biases, which
        # the two packages move with unrelated signs
        np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-2)
    assert state.step == 2 * (n // BATCH)


@pytest.mark.parametrize("preset", ["default", "sensor_cnn_bilstm_urfall"])
def test_one_step_of_other_families(preset):
    """The single-stream stgcan (``default``: 11 classes, no softmax before
    the loss) and the sensor-only CNN+BiLSTM, one step each."""
    c = Carried(preset, tiny=preset == "default", n=BATCH)
    jepoch, _ = jax_epochs(c)
    s = one_step(c, jepoch, np.arange(BATCH))
    check_loss_and_logits(s)
    check_gradients(s)
    cancelled = check_parameters(dict(s, before=c.sd))
    assert len(cancelled) == (7 if preset == "default" else 2)
