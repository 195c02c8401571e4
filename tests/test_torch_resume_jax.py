"""A JAX run resumed in the port: the JAX package's ``fit`` trains a few
steps and its ``Checkpointer`` (orbax) saves them; the converter
(``experiments/convert_jax_checkpoint.py --output <dir>``, through
``interop.optimizer_state_from_jax``) writes the port's checkpoint
directory; the port restores it and takes one more step beside one more JAX
step on the same batch. On the CPU only: the converter needs JAX, which the
card's machine lacks.

``bilstm`` (3 classes) under RMSprop, Adam and SGD with momentum, each with
``accum_iter`` 1 and 2 (3 steps an epoch, so a 2-micro-step accumulation is
half done at the checkpoint). Tolerances: the converted optimizer state
equals the JAX state at 1e-6 relative (a permutation of the same numbers);
after the step, parameters at the parity tests' 1e-5
(``tests/test_torch_train_parity.py``) and the optimizer's moments at 1e-5
relative (two float32 gradients, as the parameters); step counts equal.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.data import make_synthetic as jax_make_synthetic
from fall_multimodal_tpu.data import split_dataset as jax_split_dataset
from fall_multimodal_tpu.data import to_device as jax_to_device
from fall_multimodal_tpu.data.pipeline import gather_batch as jax_gather_batch
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.train import build_optimizer as jax_build_optimizer
from fall_multimodal_tpu.train import create_train_state as jax_create_train_state
from fall_multimodal_tpu.train import fit as jax_fit
from fall_multimodal_tpu.train import make_train_step as jax_make_train_step
from fall_multimodal_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from fall_multimodal_tpu_torch.configs import load_config
from fall_multimodal_tpu_torch.data.pipeline import DeviceData
from fall_multimodal_tpu_torch.interop import (
    _parameter_gathers,
    optimizer_state_from_jax,
    state_dict_from_jax_variables,
)
from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer
from torch_port_helpers import t, to_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 16
OPTIMIZERS = {"rmsprop": {}, "adam": {"optim.type": "adam", "optim.lr": 3e-3},
              "sgd_momentum": {"optim.type": "sgd", "optim.lr": 0.05, "optim.momentum": 0.9}}
MOMENTS = {"rmsprop": ("square_avg",), "adam": ("exp_avg", "exp_avg_sq"),
           "sgd_momentum": ("momentum_buffer",)}


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", os.path.join(ROOT, "experiments", "convert_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config_file(tmp_path, optimizer, accum):
    """A run's ``config.json``, as the JAX CLI writes it, that both packages
    read."""
    overrides = {"data.num_classes": 3, "data.sensor_dim": 6, "model.kwargs.hidden_size": 8,
                 "train.batch_size": BATCH, "train.accum_iter": accum,
                 **OPTIMIZERS[optimizer]}
    cfg = jax_load_config(os.path.join(ROOT, "fall_multimodal_tpu", "configs", "presets",
                                       "bilstm.yaml"), overrides=overrides)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg.to_dict(), default=str))
    return str(path)


@pytest.fixture(scope="module")
def data():
    raw = jax_make_synthetic(n_windows=80, num_classes=3, sensor_dim=6, windows_per_video=8,
                             noise=0.05, seed=0)
    return {k: jax_to_device(v) for k, v in jax_split_dataset(raw, seed=1).items()}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_jax_run_resumes_in_the_port(optimizer, accum, data, tmp_path):
    config = _config_file(tmp_path, optimizer, accum)
    jcfg, cfg = jax_load_config(config), load_config(config)
    model, jopt = jax_build_model(jcfg), jax_build_optimizer(jcfg)
    assert data["train"].n // BATCH == 3
    state = jax_create_train_state(model, jopt, data["train"].features[:2],
                                   data["train"].sensors[:2], seed=jcfg.seed)
    jax_fit(model, jopt, state, data, epochs=2, batch_size=BATCH, num_classes=3,
            checkpointer=JaxCheckpointer(str(tmp_path / "jax_ckpt")), epoch_impl="host")
    _converter().main(["--config", config, "--checkpoint", str(tmp_path / "jax_ckpt"),
                       "--output", str(tmp_path / "port_ckpt")])
    assert sorted(os.listdir(tmp_path / "port_ckpt")) == ["best", "latest"]

    jstate, epoch, best_acc = JaxCheckpointer(str(tmp_path / "jax_ckpt")).restore(
        "latest", state)
    port = create_train_state(cfg, build_optimizer(cfg), seed=123, device="cpu")
    port, port_epoch, port_best = Checkpointer(str(tmp_path / "port_ckpt")).restore(
        "latest", port)
    assert (port_epoch, port_best) == (epoch, best_acc) == (2, best_acc)
    assert port.step == int(jstate.step) == 6
    assert port.optimizer.gradient_step == 6 // accum
    assert port.optimizer.mini_step == 6 % accum
    assert torch.equal(port.generator.get_state(),
                       torch.Generator().manual_seed(cfg.seed).get_state())

    names, gathers, _ = _parameter_gathers(
        cfg, jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))

    def jax_moments(opt_state):
        """The JAX state's moment trees under the port's parameter names."""
        host = jax.device_get(opt_state)
        inner = host.inner_opt_state if accum > 1 else host
        core = inner[1]
        if optimizer == "rmsprop":
            trees = {"square_avg": core[0].square_avg}
        elif optimizer == "adam":
            trees = {"exp_avg": core[0].mu, "exp_avg_sq": core[0].nu}
        else:
            trees = {"momentum_buffer": core[0].trace}
        out = {}
        for key, tree in trees.items():
            sd = state_dict_from_jax_variables(
                cfg, {"params": tree, "batch_stats": jax.device_get(jstate.batch_stats)})
            out[key] = {n: sd[n] for n in names}
        return out

    def port_moments(st):
        return {key: {n: to_numpy(st.optimizer.inner.state[p][key])
                      for n, p in zip(names, st.optimizer.params)}
                for key in MOMENTS[optimizer]}

    def assert_moments(ours, theirs, rtol):
        assert ours.keys() == theirs.keys()
        for key in ours:
            for n in names:
                np.testing.assert_allclose(ours[key][n], theirs[key][n], rtol=rtol,
                                           atol=rtol * np.abs(theirs[key][n]).max(),
                                           err_msg=f"{key} {n}")

    assert_moments(port_moments(port), jax_moments(jstate.opt_state), 1e-6)
    if accum > 1:
        acc = state_dict_from_jax_variables(
            cfg, {"params": jax.device_get(jstate.opt_state.acc_grads),
                  "batch_stats": jax.device_get(jstate.batch_stats)})
        for n, a in zip(names, port.optimizer.acc):
            np.testing.assert_allclose(to_numpy(a), acc[n], rtol=1e-6, atol=1e-12)

    # one more step in each package on the same batch
    idx = np.arange(BATCH, 2 * BATCH)
    jstep = jax.jit(jax_make_train_step(model, jopt))
    jnew, jm = jstep(jstate, jax_gather_batch(data["train"], jnp.asarray(idx)))
    batch = DeviceData(*(t(np.asarray(x)[idx]) for x in
                         (data["train"].features, data["train"].labels, data["train"].sensors)))
    port, m = make_train_step(softmax_before_ce=cfg.model.softmax_output)(port, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5)
    theirs = state_dict_from_jax_variables(cfg, jax.device_get(
        {"params": jnew.params, "batch_stats": jnew.batch_stats}))
    for k, v in port.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(to_numpy(v), theirs[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert_moments(port_moments(port), jax_moments(jnew.opt_state), 1e-5)
    assert port.step == int(jnew.step) == 7
    assert port.optimizer.gradient_step == 7 // accum
    assert port.optimizer.mini_step == 7 % accum


def test_best_checkpoint_is_served_and_resumed_by_run_fold(data, tmp_path):
    """The converted directory through the port's own entry points:
    ``run_fold(resume_from=...)`` continues at the saved epoch with the
    converted best state kept for the final test."""
    from fall_multimodal_tpu_torch.data import to_device
    from fall_multimodal_tpu_torch.data.synthetic import make_synthetic
    from fall_multimodal_tpu_torch.data.loaders import split_dataset
    from fall_multimodal_tpu_torch.train.cv import run_fold

    config = _config_file(tmp_path, "rmsprop", 1)
    jcfg, cfg = jax_load_config(config), load_config(config)
    model, jopt = jax_build_model(jcfg), jax_build_optimizer(jcfg)
    state = jax_create_train_state(model, jopt, data["train"].features[:2],
                                   data["train"].sensors[:2], seed=jcfg.seed)
    jax_fit(model, jopt, state, data, epochs=2, batch_size=BATCH, num_classes=3,
            checkpointer=JaxCheckpointer(str(tmp_path / "jax_ckpt")), epoch_impl="host")
    _converter().main(["--config", config, "--checkpoint", str(tmp_path / "jax_ckpt"),
                       "--output", str(tmp_path / "port_ckpt")])
    raw = make_synthetic(n_windows=80, num_classes=3, sensor_dim=6, windows_per_video=8,
                         noise=0.05, seed=0)
    splits = {k: to_device(v, "cpu") for k, v in split_dataset(raw, seed=1).items()}
    result = run_fold(cfg, splits, epochs=3, resume_from=str(tmp_path / "port_ckpt"),
                      device="cpu")
    assert len(result.history["train_loss"]) == 1            # epoch 3 only
    assert result.state.step == 9
    assert np.isfinite(result.test.loss)


def test_unrecognised_optax_state_is_refused(data):
    """A state the map does not know (here optax's ``ScaleByBeliefState``, as
    ``adabelief`` would leave it) and a moment the config's optimizer does
    not keep are refused, with the leaf named."""
    import optax

    cfg = load_config(os.path.join(ROOT, "fall_multimodal_tpu_torch", "configs", "presets",
                                   "bilstm.yaml"),
                      overrides={"data.num_classes": 3, "data.sensor_dim": 6,
                                 "model.kwargs.hidden_size": 8})
    jcfg = jax_load_config(os.path.join(ROOT, "fall_multimodal_tpu", "configs", "presets",
                                        "bilstm.yaml"),
                           overrides={"data.num_classes": 3, "data.sensor_dim": 6,
                                      "model.kwargs.hidden_size": 8})
    model = jax_build_model(jcfg)
    state = jax_create_train_state(model, jax_build_optimizer(jcfg), data["train"].features[:2],
                                   data["train"].sensors[:2], seed=0)
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    belief = jax.device_get(optax.adabelief(1e-3).init(state.params))
    with pytest.raises(ValueError, match=r"ScaleByBeliefState at 0 has no counterpart"):
        optimizer_state_from_jax(cfg, belief, params, stats, 0)
    adam = jax.device_get(optax.adam(1e-3).init(state.params))
    with pytest.raises(ValueError, match=r"keeps \['square_avg'\]"):
        optimizer_state_from_jax(cfg, adam, params, stats, 0)
    with pytest.raises(ValueError, match="not a recognised optimizer state"):
        optimizer_state_from_jax(cfg, (np.zeros(3),), params, stats, 0)
