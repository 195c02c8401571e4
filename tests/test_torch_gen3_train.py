"""Training and k-copies serving of the Gen-3 and Gen-1 families in the
port, on the CPU.

* One train step of ``musa`` and of ``targcn`` from one state (seeded
  weights carried from the JAX package; DropGraph and dropout off) against
  the JAX package's step: the loss at 1e-5 relative; the gradients against
  a float64 run of the port, the port's at 1e-5 (+1e-4 of the tensor's
  largest element), the JAX package's at 1e-4 (+1e-2), as
  ``tests/test_torch_train_parity.py`` holds the flagship's.
* A train step repeated from one state snapshot (model, optimizer,
  generator) with DropGraph on gives the same loss and parameters, whatever
  is drawn from torch's global generator in between.
* ``cli.py --config musa_harup --device cpu`` writes a best checkpoint that
  ``Predictor`` serves.
* ``k_copies_logits`` against the JAX function (1e-6, the same forward
  under both), and ``Predictor(num_copies=2)`` against the JAX model's
  k-copies logits (2e-5) for ``musa`` and for the flagship, whose streams
  run their blocks' plain versions at T=15.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.train.loop import k_copies_logits as jax_k_copies_logits
from fall_multimodal_tpu.train.losses import cross_entropy as jax_cross_entropy
from fall_multimodal_tpu_torch import cli
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import make_synthetic
from fall_multimodal_tpu_torch.data.pipeline import DeviceData
from fall_multimodal_tpu_torch.interop import (
    load_into,
    load_state_dict_file,
    state_dict_from_jax_variables,
)
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import fused_backbone_forward
from fall_multimodal_tpu_torch.ops.stgcan_block import fused_stgcan_block
from fall_multimodal_tpu_torch.serve import Predictor
from fall_multimodal_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    cross_entropy,
    k_copies_logits,
    make_train_step,
)
from torch_port_helpers import random_init, t, to_numpy

torch.set_num_threads(1)

TOL = 1e-5
BATCH = 8
OFF = {"musa": {"embed_dim": 16, "keep_prob": 1.0, "dropout": 0.0},
       "targcn": {"rnn_units": 8, "embed_dim": 4, "output_dim": 8}}
PRESETS = {"musa": "musa_harup", "targcn": "targcn_harup"}


def _configs(preset, kwargs):
    out = []
    for load, path in ((jax_load_config, jax_preset_path), (load_config, preset_path)):
        cfg = load(path(preset))
        out.append(cfg.replace(model=dataclasses.replace(
            cfg.model, kwargs=dict(cfg.model.kwargs, **kwargs))))
    return out


def _batch(cfg, n=BATCH, seed=5):
    d = cfg.data
    data = make_synthetic(n_windows=n, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          seed=seed)
    return data.features, data.labels, data.sensors


@pytest.mark.parametrize("family", ["musa", "targcn"])
def test_one_train_step_matches_jax(family):
    jcfg, cfg = _configs(PRESETS[family], OFF[family])
    _, labels, _ = _batch(cfg)
    # Normal inputs and a seed whose batch statistics are well conditioned.
    # musa's float32 gradients go through BatchNorms of tanh outputs: where a
    # channel saturates (|mean| >> std) both packages' float32 BatchNorm
    # cancels, and on some seeds (3, 4, 5) or on the synthetic poses their
    # gradients sit up to 3e-2 of a tensor's largest element from float64,
    # the port's and the JAX package's alike; on seed 6 5e-6 relative L2.
    rng = np.random.default_rng(6)
    skel = rng.normal(size=(BATCH, 30, 14, 3)).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    variables = random_init(jmodel, rng, jnp.asarray(skel[:2]), None, train=False)
    batch_stats = variables.get("batch_stats", {})

    @jax.jit
    def jax_loss_and_grads(params):
        def loss_fn(p):
            out = jmodel.apply({"params": p, "batch_stats": batch_stats}, jnp.asarray(skel),
                               None, train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.key(0)})[0]
            return jax_cross_entropy(out, jnp.asarray(labels))

        return jax.value_and_grad(loss_fn)(params)

    jloss, jgrads = jax_loss_and_grads(variables["params"])
    jgrads = state_dict_from_jax_variables(
        cfg, {"params": jax.device_get(jgrads), "batch_stats": batch_stats})

    state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
    load_into(state.model, state_dict_from_jax_variables(cfg, variables))
    model64 = state.snapshot().model.double().train()
    cross_entropy(model64(t(skel).double(), None), t(labels).double()).backward()
    # the sep blocks' ``edge`` masks reach the output only through DropGraph
    grads64 = {k: to_numpy(p.grad) if p.grad is not None else np.zeros(p.shape)
               for k, p in model64.named_parameters()}

    batch = DeviceData(t(skel), t(labels), t(np.zeros((BATCH, 1, 1))))
    _, metrics = make_train_step()(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=TOL)
    for name, p in state.model.named_parameters():
        g64 = grads64[name]
        grad = to_numpy(p.grad) if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(grad, g64,
                                   atol=TOL + 1e-4 * np.abs(g64).max(), err_msg=name)
        np.testing.assert_allclose(jgrads[name], g64,
                                   atol=10 * TOL + 1e-2 * np.abs(g64).max(), err_msg=name)
    assert len(grads64) > 40


def test_step_from_a_snapshot_repeats_with_dropgraph_on():
    """Two train steps from one ``TrainState.snapshot()`` of a ``musa`` with
    DropGraph (keep_prob 0.9) and the head's dropout on: identical losses
    and parameters, with torch's global generator drawn from between them;
    another generator seed gives another loss."""
    _, cfg = _configs("musa_harup", {"embed_dim": 16})
    skel, labels, _ = _batch(cfg, n=16)
    batches = [DeviceData(t(skel[i::2]), t(labels[i::2]), t(np.zeros((8, 1, 1))))
               for i in range(2)]
    step = make_train_step()
    state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
    snap = state.snapshot()
    other = state.snapshot()
    other.generator.manual_seed(123)

    def run(s):
        losses = []
        for b in batches:
            torch.rand(1000)
            losses.append(float(step(s, b)[1]["loss"]))
            torch.randn(77)
        return losses

    first, again, moved = run(state), run(snap), run(other)
    assert first == again
    for (name, p), q in zip(state.model.named_parameters(), snap.model.parameters()):
        assert torch.equal(p, q), name
    assert abs(moved[0] - first[0]) > 1e-6


def test_cli_trains_musa_and_predictor_serves_its_best_checkpoint(tmp_path):
    out = tmp_path / "run"
    result = cli.main(["--config", "musa_harup", "--device", "cpu", "--output-dir", str(out),
                       "--set", "train.epochs=1", "--set", "train.batch_size=16",
                       "--set", "model.kwargs.embed_dim=16", "--synthetic-windows", "96"])
    assert 0.0 <= result["test_accuracy"] <= 1.0
    best = out / "ckpt" / "best" / "checkpoint.pt"
    assert best.exists() and (out / "history.json").exists()
    cfg = cli.load_cli_config(cli.parse_args(["--config", "musa_harup",
                                              "--set", "model.kwargs.embed_dim=16"]))
    pred = Predictor.from_torch_checkpoint(cfg, str(best), batch_size=4, device="cpu")
    skel, _, _ = _batch(cfg, n=6)
    logits = pred.predict_logits(skel)                   # musa reads no sensor
    model = load_into(build_model(cfg), load_state_dict_file(str(best))).eval()
    with torch.no_grad():
        np.testing.assert_allclose(logits, to_numpy(model(t(skel))), atol=1e-6)
    assert logits.shape == (6, 11) and np.isfinite(logits).all()


@pytest.mark.parametrize("preset,sensor_dim", [("musa_fukinect", 0), ("musa_imvia", 0)])
def test_gen3_presets_without_a_sensor_stream_train_and_serve(preset, sensor_dim, tmp_path):
    """FUKinect and ImVia have no sensor stream: the splits carry the (N, 1,
    1) placeholder through the train step and the eval epoch, and the
    Predictor takes ``sensor=None``."""
    out = tmp_path / preset
    cli.main(["--config", preset, "--device", "cpu", "--output-dir", str(out),
              "--set", "train.epochs=1", "--set", "train.batch_size=16",
              "--set", "model.kwargs.embed_dim=8", "--synthetic-windows", "64"])
    cfg = cli.load_cli_config(cli.parse_args(["--config", preset,
                                              "--set", "model.kwargs.embed_dim=8"]))
    assert cfg.data.sensor_dim == sensor_dim
    pred = Predictor.from_torch_checkpoint(cfg, str(out / "ckpt" / "best" / "checkpoint.pt"),
                                           batch_size=4, device="cpu")
    assert not pred.requires_sensor
    skel, _, _ = _batch(cfg, n=3)
    assert pred.predict_logits(skel).shape == (3, cfg.data.num_classes)


@pytest.fixture(scope="module")
def musa_pair():
    jcfg, cfg = _configs("musa_harup", {"embed_dim": 16})
    skel, _, _ = _batch(cfg, n=3)
    jmodel = jax_build_model(jcfg)
    variables = random_init(jmodel, np.random.default_rng(4), jnp.asarray(skel[:2]), None,
                            train=False)
    return jcfg, cfg, jmodel, variables, skel


@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_k_copies_logits_matches_jax(musa_pair, k):
    """The port's slicing and averaging against the JAX function's, both
    around the JAX model's forward (1e-6); and the port's own model under
    k-copies against the JAX package's (2e-5)."""
    jcfg, cfg, jmodel, variables, skel = musa_pair
    ref = np.asarray(jax_k_copies_logits(jmodel, variables, jnp.asarray(skel), None, k))

    def jax_forward(x, sensor):
        return torch.from_numpy(np.array(jmodel.apply(variables, jnp.asarray(to_numpy(x)),
                                                        None, train=False)))

    np.testing.assert_allclose(to_numpy(k_copies_logits(jax_forward, t(skel), None, k)), ref,
                               atol=1e-6)
    model = load_into(build_model(cfg), state_dict_from_jax_variables(cfg, variables)).eval()
    with torch.no_grad():
        ours = k_copies_logits(lambda x, s: model(x, s), t(skel), None, k)
    np.testing.assert_allclose(to_numpy(ours), ref, atol=2e-5)


@pytest.mark.parametrize("k", [0, 31])
def test_k_copies_out_of_range_is_refused(musa_pair, k):
    jcfg, cfg, jmodel, variables, skel = musa_pair
    with pytest.raises(ValueError, match="num_copies"):
        jax_k_copies_logits(jmodel, variables, jnp.asarray(skel), None, k)
    with pytest.raises(ValueError, match="num_copies"):
        k_copies_logits(lambda x, s: x, t(skel), None, k)
    with pytest.raises(ValueError, match="num_copies"):
        Predictor(cfg, state_dict_from_jax_variables(cfg, variables), device="cpu",
                  num_copies=k)


NARROW = ((16, 1, False), (16, 1, True), (32, 2, True))


@pytest.mark.parametrize("preset,kwargs", [("musa_harup", {"embed_dim": 16}),
                                           ("gstcan_urfall_3stream", {"stages": NARROW})],
                         ids=["musa", "gstcan_3stream"])
def test_predictor_serves_k_copies(preset, kwargs):
    """``Predictor(num_copies=2)`` on the CPU against the JAX model's
    k-copies logits; the flagship's streams run their blocks' plain versions
    (K1's CPU path) on each T=15 slice, and ``with_batch_size`` keeps k."""
    jcfg, cfg = _configs(preset, kwargs)
    rng = np.random.default_rng(6)
    d = cfg.data
    skel = rng.normal(size=(5, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sensor = rng.normal(size=(5, d.seq_len, max(d.sensor_dim, 1))).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    variables = random_init(jmodel, rng, jnp.asarray(skel[:2]), jnp.asarray(sensor[:2]),
                            train=False)
    ref = np.asarray(jax_k_copies_logits(jmodel, variables, jnp.asarray(skel),
                                         jnp.asarray(sensor), 2))
    pred = Predictor(cfg, state_dict_from_jax_variables(cfg, variables), batch_size=4,
                     device="cpu", num_copies=2)
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    out = pred.predict_logits(skel, sensor if pred.requires_sensor else None)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert pred.with_batch_size(1).num_copies == 2
    assert fused_stgcan_block.launches == 0          # CPU tensors: the plain versions
    single = Predictor(cfg, state_dict_from_jax_variables(cfg, variables), batch_size=4,
                       device="cpu").predict_logits(skel, sensor if pred.requires_sensor
                                                    else None)
    assert np.abs(single - out).max() > 1e-4         # k-copies is not the one-window forward


def test_predictor_refuses_k_copies_for_targcn():
    """TARGCN's temporal attention takes T as channels, so a T/k slice
    cannot pass: ``num_copies`` > 1 is refused when the predictor is built,
    not at the first request; ``num_copies=1`` serves."""
    cfg = _configs("targcn_harup", {"rnn_units": 8, "embed_dim": 2})[1]
    sd = build_model(cfg).state_dict()
    with pytest.raises(ValueError, match="num_copies=2"):
        Predictor(cfg, sd, device="cpu", num_copies=2)
    d = cfg.data
    skel = np.random.default_rng(0).normal(size=(2, d.seq_len, d.num_joints,
                                                  d.in_channels)).astype(np.float32)
    out = Predictor(cfg, sd, batch_size=2, device="cpu").predict_logits(skel)
    assert out.shape == (2, d.num_classes) and np.isfinite(out).all()
