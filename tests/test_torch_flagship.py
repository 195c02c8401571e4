"""The port's flagship, the 3-stream GSTCAN (``gstcan_urfall_3stream``),
against the reference fixture and against the JAX package.

* ``reference_gstcan3.npz`` loads with ``load_state_dict(strict=True)``
  and reproduces the reference's softmax output at 2e-5, the anchor of
  ``tests/test_gstcan3_parity.py``;
* JAX variables converted from the fixture carry back to the fixture;
* on seeded random JAX weights scaled like a trained network, the port's Predictor logits match the JAX
  Predictor's at 5e-5: two float32 CPU implementations (XLA convolutions
  and dense GCN vs the port's folded blocks) that sum a 7-block network in
  different orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.interop import torch_to_variables
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.serve import Predictor as JaxPredictor
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.interop import (
    DEAD_REFERENCE_KEYS,
    _conv1x1_inv,
    _FlaxReader,
    _Writer,
    load_into,
    load_state_dict_file,
    state_dict_from_jax_variables,
)
from fall_multimodal_tpu_torch.models import STGCANBackbone, build_model
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
from fall_multimodal_tpu_torch.ops.stgcan_block import fused_stgcan_block
from fall_multimodal_tpu_torch.serve import Predictor
from torch_port_helpers import t, to_numpy, random_init

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "reference_gstcan3.npz")
CFG = preset_path("gstcan_urfall_3stream")


@pytest.fixture(scope="module")
def fixture():
    g = np.load(FIX)
    skel = np.ascontiguousarray(np.transpose(g["x"], (0, 2, 3, 1)))   # -> (N, T, V, C)
    sd = load_state_dict_file(FIX)
    return skel, np.asarray(g["sensor"]), np.asarray(g["out"]), sd, g


def test_fixture_loads_strict_and_matches_reference(fixture):
    skel, sensor, expected, sd, g = fixture
    # the loader drops exactly the reference's dead CNN1D head, nothing else
    dead = {"sensor.cnn.fc.weight", "sensor.cnn.fc.bias"}
    assert set(g.files) - set(sd) == {"x", "sensor", "out", *dead}
    assert dead <= set(DEAD_REFERENCE_KEYS)
    cfg = load_config(CFG)
    model = build_model(cfg).eval()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = torch.softmax(model(t(skel), t(sensor)), dim=-1)
    np.testing.assert_allclose(to_numpy(ours), expected, atol=2e-5)
    pred = Predictor(cfg, sd, batch_size=4, device="cpu")
    np.testing.assert_allclose(pred.predict_proba(skel, sensor), expected, atol=2e-5)
    assert fused_stgcan_block.launches == 0


def test_jax_variables_carry_back_to_the_fixture(fixture):
    *_, sd, _ = fixture
    variables = jax.device_get(torch_to_variables(jax_load_config(CFG), sd))
    back = state_dict_from_jax_variables(load_config(CFG), variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_jax_variables_missing_a_leaf_are_refused(fixture):
    *_, sd, _ = fixture
    variables = jax.device_get(torch_to_variables(jax_load_config(CFG), sd))
    del variables["params"]["Dense_0"]["bias"]
    with pytest.raises(KeyError, match="Dense_0.bias"):
        state_dict_from_jax_variables(load_config(CFG), variables)


@pytest.fixture(scope="module")
def carried():
    rng = np.random.default_rng(7)
    jcfg = jax_load_config(CFG)
    d = jcfg.data
    variables = random_init(
        jax_build_model(jcfg), rng, jnp.zeros((2, d.seq_len, d.num_joints, d.in_channels)),
        jnp.zeros((2, d.seq_len, d.sensor_dim)), train=False)
    cfg = load_config(CFG)
    sd = state_dict_from_jax_variables(cfg, variables)
    skel = rng.normal(size=(6, 30, 14, 3)).astype(np.float32)
    sensor = rng.normal(size=(6, 30, 4)).astype(np.float32)
    return jcfg, variables, cfg, sd, skel, sensor


def test_predictor_matches_jax_predictor(carried):
    jcfg, variables, cfg, sd, skel, sensor = carried
    ref = JaxPredictor(jcfg, variables, batch_size=4).predict_logits(skel, sensor)
    ours = Predictor(cfg, sd, batch_size=4, device="cpu").predict_logits(skel, sensor)
    assert np.ptp(ref, axis=0).min() > 0.05     # the windows are told apart
    np.testing.assert_allclose(ours, ref, atol=5e-5)


@pytest.mark.parametrize("n", [1, 5, 7])
def test_ragged_batches_match_the_module(carried, n):
    *_, cfg, sd, skel, sensor = carried
    skel = np.concatenate([skel, skel])[:n]
    sensor = np.concatenate([sensor, sensor])[:n]
    pred = Predictor(cfg, sd, batch_size=4, device="cpu")
    with torch.no_grad():
        ref = pred.model(t(skel), t(sensor))
    out = pred.predict_logits(skel, sensor)
    assert out.shape == (n, 2)
    np.testing.assert_allclose(out, to_numpy(ref), atol=2e-5)
    assert pred.predict(skel, sensor).shape == (n,)


def test_sensor_none_and_mismatch_are_refused(carried):
    *_, cfg, sd, skel, sensor = carried
    pred = Predictor(cfg, sd, batch_size=4, device="cpu")
    assert pred.requires_sensor
    with pytest.raises(ValueError, match="consumes the sensor"):
        pred.predict_logits(skel)
    with pytest.raises(ValueError, match="counts must match"):
        pred.predict_logits(skel, sensor[:2])
    assert pred.predict_logits(skel[:0], sensor[:0]).shape == (0, 2)


def test_state_dict_with_a_wrong_key_is_refused(carried):
    *_, cfg, sd, _, _ = carried
    bad = dict(sd)
    bad["fcn.extra"] = bad.pop("fcn.bias")
    with pytest.raises(ValueError, match=r"missing fcn\.bias.*unused fcn\.extra"):
        Predictor(cfg, bad, device="cpu")


def test_fused_backbone_with_head_matches_flax(rng):
    """The executor's optional ``cls`` head and a short stage plan, against
    the flax backbone (``test_pallas_kernel.py:81-100``)."""
    from fall_multimodal_tpu.models.stgcan import STGCANBackbone as JaxBackbone

    stages = ((16, 1, False), (16, 1, True), (32, 2, True))
    jb = JaxBackbone(stages=stages, num_classes=5)
    x = rng.normal(size=(4, 30, 14, 3)).astype(np.float32)
    v = random_init(jb, rng, jnp.asarray(x), train=True)
    ref = np.asarray(jb.apply(v, jnp.asarray(x), train=False))
    port = STGCANBackbone(3, stages=stages, num_classes=5)
    w = _Writer(_FlaxReader({"bb": v["params"]}), _FlaxReader({"bb": v["batch_stats"]}))
    w.backbone("bb", "bb", stages, 3, to_numpy(port.A))
    w.dense("bb.cls", "bb", "cls", inv=_conv1x1_inv)
    load_into(port, {k[3:]: a for k, a in w.sd.items()}).eval()
    ours = FusedBackbone(port)(t(x))
    np.testing.assert_allclose(to_numpy(ours), ref, atol=3e-5)
