"""The port's seeded init schemes (``models/init.py``: ``torch``,
``init_param``, ``flax``) over the Gen-3 and Gen-1 families' parameters,
against the JAX package's (its flax init, then its ``reinitialize``). The
draws cannot be equal (``torch.Generator`` is not ``jax.random``): every
tensor is held by its spread (to the sampling error of its size), its bound
and its constants."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.models.init import reinitialize as jax_reinitialize
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.interop import state_dict_from_jax_variables
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.models.init import reinitialize, seeded_model
from torch_port_helpers import to_numpy


def _configs(preset, kwargs):
    out = []
    for load, path in ((jax_load_config, jax_preset_path), (load_config, preset_path)):
        cfg = load(path(preset))
        out.append(cfg.replace(model=dataclasses.replace(
            cfg.model, kwargs=dict(cfg.model.kwargs, **kwargs))))
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(preset, kwargs):
    """The JAX model's flax init (shapes and construction-time values)."""
    jcfg, cfg = _configs(preset, dict(kwargs))
    d = cfg.data
    skel = jnp.zeros((2, d.seq_len, d.num_joints, d.in_channels))
    sensor = jnp.zeros((2, d.seq_len, d.sensor_dim))
    return jax.device_get(jax.jit(lambda: jax_build_model(jcfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, skel, sensor,
        train=False))())


@pytest.mark.parametrize("scheme", ["torch", "init_param", "flax"])
@pytest.mark.parametrize("preset,kwargs", [
    ("musa_harup", {"embed_dim": 16}),
    ("targcn_harup", {"rnn_units": 16, "embed_dim": 8, "output_dim": 16}),
    ("transformer_ensemble_harup", {"embedding_dim": 32, "n_block": 2}),
], ids=["musa", "targcn", "transformer_ensemble"])
def test_init_schemes_draw_as_the_jax_package(preset, kwargs, scheme):
    """Every parameter of the new families under each init scheme has the
    JAX package's distribution (its flax init, then ``reinitialize``): the
    same spread per tensor (to the sampling error of its size), the same
    bound, and the same constants (zero biases, unit norms, ones for the
    ``edge`` masks); depthwise, TA and ``end_conv`` kernels have the flax
    fans."""
    jcfg, cfg = _configs(preset, kwargs)
    variables = _jax_init(preset, tuple(sorted(kwargs.items())))
    params = jax.device_get(jax_reinitialize(variables["params"], 5, scheme))
    ref = state_dict_from_jax_variables(cfg, {"params": params,
                                              "batch_stats": variables.get("batch_stats", {})})
    ours = reinitialize(build_model(cfg), seed=5, scheme=scheme).state_dict()
    checked = 0
    for name, value in ours.items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked", ".A", ".pe")):
            continue
        mine, theirs = to_numpy(value).astype(np.float64), ref[name].astype(np.float64)
        if theirs.std() == 0:                        # constants: zeros, ones
            np.testing.assert_array_equal(mine, theirs, err_msg=name)
            continue
        n = theirs.size
        if n < 32:
            continue
        assert mine.std() == pytest.approx(theirs.std(), rel=0.02 + 5 / np.sqrt(n)), name
        assert np.abs(mine).max() <= np.abs(theirs).max() * (1 + 0.5 + 5 / np.sqrt(n)), name
        checked += 1
    assert checked > 10


@pytest.mark.parametrize("preset", ["targcn_harup", "musa_harup"])
def test_seeded_model_is_repeatable_and_conditioned(preset):
    """``seeded_model``: one seed gives one state_dict; TARGCN's pools are
    scaled to variance 1/fan_in (weights) and 0.01/embed_dim (biases); the
    BatchNorm running statistics are a batch's, not the init's zeros; the
    model comes back in eval mode."""
    cfg = _configs(preset, {})[1]
    model = seeded_model(cfg, seed=3, n=8)
    again = seeded_model(cfg, seed=3, n=8).state_dict()
    assert not model.training
    sd = model.state_dict()
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
    pools = {k: v for k, v in sd.items() if k.endswith("_pool")}
    assert bool(pools) == (preset == "targcn_harup")
    for k, v in pools.items():
        fan = v.shape[0] * v.shape[1] if k.endswith("weights_pool") else v.shape[0] / 0.01
        np.testing.assert_allclose(float(v.var()) * fan, 1.0, rtol=0.15)
    means = [v for k, v in sd.items() if k.endswith("running_mean")]
    assert bool(means) == (preset == "musa_harup")           # TARGCN has no BatchNorm
    assert all(float(m.abs().max()) > 0 for m in means)
