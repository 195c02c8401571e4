"""The Gen-3 and Gen-1 model families of the port (``musa``,
``musa_ablation``, ``targcn``, ``skeleton_transformer``,
``skeleton_transformer_factorized``, ``transformer_ensemble``) against the
reference's own outputs (the committed fixtures) and against the JAX
package's modules, on the CPU.

Tolerances: the fixtures at the JAX package's own parity tests' (musa 2e-5,
``tests/test_musa_parity.py:47``; TARGCN 5e-5, ``test_targcn_parity.py:210``,
and its module fixtures 2e-5 / 2e-5 / 3e-5; both skeleton transformers
3e-5, ``test_skeltrans_parity.py:46,77``). Against the JAX package: 2e-5 at
a small width (two float32 CPU implementations summing in other orders),
1e-4 at the presets' full widths. Weights are seeded (numpy), scaled like a
trained network (``random_init``), made as JAX variables and carried over
by ``state_dict_from_jax_variables``. The transformers' norm scales and
their attention's ``w_qkv`` are halved, so that activations stay O(1)
through six B2T residuals: unhalved, logits reach 1e6 and float32 rounding
decides the softmaxes (the port in float32 then sits 2e-3 relative from
itself in float64; halved, 5e-7 absolute).

Train mode is compared with every draw switched off; the draws themselves
are held in ``tests/test_torch_gen3_draws.py``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.models import skeleton_transformer as jax_st
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.interop import (
    _FlaxReader,
    _Writer,
    load_into,
    load_state_dict_file,
    state_dict_from_jax_variables,
)
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.models import skeleton_transformer, targcn
from torch_port_helpers import random_init, t, to_numpy

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = {
    "musa": ("musa_harup", {"embed_dim": 16}),
    "musa_ablation": ("musa_ablation_harup", {"embed_dim": 16}),
    "targcn": ("targcn_harup", {"rnn_units": 8, "embed_dim": 4, "output_dim": 8}),
    "skeleton_transformer": ("skeleton_transformer_harup", {"embedding_dim": 16, "n_block": 2}),
    "skeleton_transformer_factorized": (
        "skeleton_transformer_harup", {"embedding_dim": 16, "n_block": 2}),
    "transformer_ensemble": ("transformer_ensemble_harup", {"embedding_dim": 16, "n_block": 2}),
}


def _configs(preset, name=None, kwargs=None):
    """The same preset read by each package from its own copy, with the
    model name and kwargs overridden alike."""
    out = []
    for load, path in ((jax_load_config, jax_preset_path), (load_config, preset_path)):
        cfg = load(path(preset))
        model = dataclasses.replace(cfg.model, name=name or cfg.model.name,
                                    kwargs=dict(cfg.model.kwargs, **(kwargs or {})))
        out.append(cfg.replace(model=model))
    return out


def condition(variables):
    """Halve the scale of every norm and the ``w_qkv`` kernels of a
    transformer (see the module docstring); other families pass through."""
    def leaf(path, x):
        names = [str(getattr(p, "key", "")) for p in path]
        if names[-1] == "scale" and any(n.startswith("norm") for n in names):
            return x * 0.5
        if names[-1] == "kernel" and "w_qkv" in names:
            return x * 0.5
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def carry(preset, name=None, kwargs=None, n=3, seed=3):
    """(JAX config, port config, JAX model, variables, skeleton, sensor)."""
    jcfg, cfg = _configs(preset, name, kwargs)
    rng = np.random.default_rng(seed)
    d = cfg.data
    skel = rng.normal(size=(n, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sensor = rng.normal(size=(n, d.seq_len, max(d.sensor_dim, 1))).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    variables = condition(random_init(jmodel, rng, jnp.asarray(skel[:2]),
                                      jnp.asarray(sensor[:2]), train=False))
    return jcfg, cfg, jmodel, variables, skel, sensor


# ---- the reference's own outputs -----------------------------------------

FIXTURES = {
    "musa": ("reference_musa.npz", {"embed_dim": 16, "n_stage": 1, "act_type": "tanh",
                                    "block_size": 41, "edge": True, "bias": True},
             {"graph.strategy": "uniform"}, (0, 2, 3, 1), 2e-5),
    "targcn": ("reference_targcn_full.npz", {"rnn_units": 8, "output_dim": 8, "horizon": 30,
                                             "num_layers": 2, "embed_dim": 4}, {}, None, 5e-5),
    "skeleton_transformer": ("reference_skeltrans.npz",
                             {"embedding_dim": 16, "n_block": 2, "head_dim": 4, "n_heads": 2},
                             {}, (0, 4, 2, 3, 1), 3e-5),
    "skeleton_transformer_factorized": (
        "reference_skeltrans_ablation1.npz",
        {"embedding_dim": 16, "n_block": 2, "head_dim": 4, "n_heads": 2}, {},
        (0, 4, 2, 3, 1), 3e-5),
}


def _fixture_config(name):
    _, kwargs, over, _, _ = FIXTURES[name]
    return load_config(preset_path("default"), overrides={
        "model.name": name, "data.num_classes": 11, "model.kwargs": kwargs, **over})


@pytest.mark.parametrize("name", list(FIXTURES))
def test_reference_fixture_reproduces_out(name):
    """The reference checkpoint loads strictly (no key missing or left over,
    the saved constants checked) and reproduces the reference's output."""
    fname, _, _, perm, tol = FIXTURES[name]
    path = os.path.join(FIX, fname)
    sd = load_state_dict_file(path)
    model = load_into(build_model(_fixture_config(name)), sd).eval()
    assert set(sd) == set(model.state_dict())
    with np.load(path) as g:
        x = g["x"] if perm is None else np.transpose(g["x"], perm)
        expected = g["out"]
    with torch.no_grad():
        out = to_numpy(model(t(x)))
    np.testing.assert_allclose(out, expected, atol=tol)


def test_saved_constants_must_match_the_config():
    sd = load_state_dict_file(os.path.join(FIX, "reference_musa.npz"))
    sd["stream_mot.1.A"] = sd["stream_mot.1.A"] * 1.01
    with pytest.raises(ValueError, match="stream_mot.1.A"):
        load_into(build_model(_fixture_config("musa")), sd)
    sd = load_state_dict_file(os.path.join(FIX, "reference_targcn_full.npz"))
    sd["encoder.trans_layer_T.PE.pe"] = np.zeros_like(sd["encoder.trans_layer_T.PE.pe"])
    with pytest.raises(ValueError, match="PE.pe"):
        load_into(build_model(_fixture_config("targcn")), sd)


def test_targcn_module_fixtures():
    """``reference_targcn.npz``'s EmbGCN (static adjacency given), graph-GRU
    cell and TA layer outputs at 2e-5, 2e-5 and 3e-5."""
    g = np.load(os.path.join(FIX, "reference_targcn.npz"))
    adj, x, emb = g["adj"], t(g["x"]), t(g["node_emb"])
    gcn = targcn.EmbGCN(3, 16, 8, 14, static_adj=adj)
    load_into(gcn, {"weights_pool": g["weights_pool"], "bias_pool": g["bias_pool"],
                    "linear.weight": g["linear_w"], "linear.bias": g["linear_b"]})
    cell = targcn.GraphGRUCell(3, 16, 8, 14, static_adj=adj)
    load_into(cell, {k[4:]: g[k] for k in g.files if k.startswith("gru.")})
    ta = targcn.TemporalTransformLayer(16, 30)
    load_into(ta, {k[3:]: g[k] for k in g.files if k.startswith("ta.")})
    with torch.no_grad():
        np.testing.assert_allclose(to_numpy(gcn(x, emb)), g["embgcn_out"], atol=2e-5)
        np.testing.assert_allclose(to_numpy(cell(x, t(g["h0"]), emb)), g["gru_out"], atol=2e-5)
        np.testing.assert_allclose(to_numpy(ta(t(g["ta_x"]))), g["ta_out"], atol=3e-5)


# ---- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("name", list(SMALL))
def test_family_matches_jax_at_small_width(name):
    preset, kwargs = SMALL[name]
    jcfg, cfg, jmodel, variables, skel, sensor = carry(preset, name, kwargs)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(skel), jnp.asarray(sensor),
                                  train=False))
    sd = state_dict_from_jax_variables(cfg, variables)
    model = load_into(build_model(cfg), sd).eval()
    assert list(sd) == list(model.state_dict())
    with torch.no_grad():
        ours = to_numpy(model(t(skel), t(sensor)))
    assert np.ptp(ref, axis=0).min() > 1e-3          # the windows are told apart
    np.testing.assert_allclose(ours, ref, atol=2e-5)


@pytest.mark.parametrize("preset", ["musa_harup", "targcn_harup", "skeleton_transformer_harup",
                                    "transformer_ensemble_harup"])
def test_family_matches_jax_at_full_width(preset):
    """One eval forward of the preset's own widths (batch 2)."""
    jcfg, cfg, jmodel, variables, skel, sensor = carry(preset, n=2)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(skel), jnp.asarray(sensor),
                                  train=False))
    model = load_into(build_model(cfg), state_dict_from_jax_variables(cfg, variables)).eval()
    with torch.no_grad():
        ours = to_numpy(model(t(skel), t(sensor)))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("name", ["musa", "musa_ablation"])
def test_musa_train_mode_matches_jax_with_draws_off(name):
    """Train-mode logits (batch statistics) and the updated running
    statistics, with DropGraph (``keep_prob=1``) and the head's dropout off."""
    preset, kwargs = SMALL[name]
    jcfg, cfg, jmodel, variables, skel, sensor = carry(
        preset, name, dict(kwargs, keep_prob=1.0, dropout=0.0), n=4)
    ref, new = jmodel.apply(variables, jnp.asarray(skel), None, train=True,
                            mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
    sd = state_dict_from_jax_variables(cfg, variables)
    model = load_into(build_model(cfg), sd).train()
    before = torch.get_rng_state()
    with torch.no_grad():
        ours = to_numpy(model(t(skel), None, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(torch.get_rng_state(), before)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5)
    stepped = state_dict_from_jax_variables(
        cfg, {"params": variables["params"], "batch_stats": jax.device_get(new["batch_stats"])})
    stats = {k: v for k, v in model.state_dict().items() if k.endswith(("_mean", "_var"))}
    assert len(stats) > 20
    for k, v in stats.items():
        np.testing.assert_allclose(to_numpy(v), stepped[k], atol=2e-5, err_msg=k)


def test_targcn_train_mode_is_its_eval_forward():
    """TARGCN has no BatchNorm and draws nothing: its train-mode forward is
    the JAX train-mode forward and the eval forward."""
    preset, kwargs = SMALL["targcn"]
    jcfg, cfg, jmodel, variables, skel, sensor = carry(preset, "targcn", kwargs)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(skel), None, train=True))
    model = load_into(build_model(cfg), state_dict_from_jax_variables(cfg, variables))
    with torch.no_grad():
        train = to_numpy(model.train()(t(skel)))
        evaluated = to_numpy(model.eval()(t(skel)))
    np.testing.assert_allclose(train, ref, atol=2e-5)
    np.testing.assert_array_equal(train, evaluated)


@pytest.mark.parametrize("variant", ["nogate", "linear", "sa"])
def test_targcn_gcn_variants_match_jax(variant):
    preset, kwargs = SMALL["targcn"]
    jcfg, cfg, jmodel, variables, skel, sensor = carry(
        preset, "targcn", dict(kwargs, gcn_variant=variant))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(skel), None, train=False))
    model = load_into(build_model(cfg), state_dict_from_jax_variables(cfg, variables)).eval()
    with torch.no_grad():
        np.testing.assert_allclose(to_numpy(model(t(skel))), ref, atol=2e-5)


def _block_variables(module, x, rng):
    return condition(random_init(module, rng, x, train=False))


def _carry_block(jblock, port_block, write, x, train):
    """A JAX block and the port's counterpart on the same variables:
    (JAX output, port output), train mode with its batch statistics."""
    rng = np.random.default_rng(7)
    variables = _block_variables(jblock, jnp.asarray(x), rng)
    w = _Writer(_FlaxReader(variables["params"]), _FlaxReader(variables.get("batch_stats", {})))
    write(w)
    assert not (w.p.unused() | w.s.unused())
    load_into(port_block, {k[2:]: v for k, v in w.sd.items()})
    if train:
        ref, _ = jblock.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
    else:
        ref = jblock.apply(variables, jnp.asarray(x), train=False)
    port_block.train(train)
    with torch.no_grad():
        out = port_block(t(x), torch.Generator().manual_seed(0))
    return np.asarray(ref), to_numpy(out)


BLOCK_ARGS = dict(head_dim=4, n_heads=2, n_joints=14, seq_len=30)


def _blocks():
    """(JAX block, port block, writer, frames-last): the two blocks the
    registered transformers build; the single-axis block of Ablation1 once
    over the joints and once over the frames (input with T and V swapped)."""
    def single(w):
        w.b2t_block("b")

    return {
        "b2t_batchnorm": (
            jax_st.B2TSpatialTemporalBlock(**BLOCK_ARGS, sd_rate=0.0, ffn_dropout=0.0),
            skeleton_transformer.B2TSpatialTemporalBlock(16, **BLOCK_ARGS, sd_rate=0.0,
                                                          ffn_dropout=0.0),
            lambda w: w.b2t_st_block("b"), False),
        "b2t_spatial": (jax_st.B2TBlock(4, 2, 14, ffn_dropout=0.0),
                        skeleton_transformer.B2TBlock(16, 4, 2, 14, ffn_dropout=0.0),
                        single, False),
        "b2t_temporal": (jax_st.B2TBlock(4, 2, 30, ffn_dropout=0.0),
                         skeleton_transformer.B2TBlock(16, 4, 2, 30, ffn_dropout=0.0),
                         single, True),
    }


@pytest.mark.parametrize("block,train", [
    ("b2t_batchnorm", False), ("b2t_batchnorm", True), ("b2t_spatial", False),
    ("b2t_spatial", True), ("b2t_temporal", False), ("b2t_temporal", True)])
def test_transformer_blocks_match_jax(block, train):
    """Each block of the skeleton transformers (5-D input, persons M = 2),
    in eval and, with stochastic depth and the FFN's dropout at 0, in train
    mode (the BatchNorm block with its batch statistics)."""
    jblock, port_block, write, frames_last = _blocks()[block]
    x = np.random.default_rng(1).normal(size=(3, 2, 30, 14, 16)).astype(np.float32)
    if frames_last:
        x = np.ascontiguousarray(x.swapaxes(2, 3))
    ref, ours = _carry_block(jblock, port_block, write, x, train)
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_relpos_attention_over_frames_is_over_axis_minus_3():
    """The temporal attention (axis -3) is the spatial one (axis -2) with T
    and V swapped, and a permutation of a leading axis commutes with it."""
    torch.manual_seed(0)
    att_t = skeleton_transformer.RelPosMHSA(16, 4, 2, 30, axis=-3)
    att_s = skeleton_transformer.RelPosMHSA(16, 4, 2, 30, axis=-2)
    att_s.load_state_dict(att_t.state_dict())
    with torch.no_grad():
        att_t.relative_position_bias_table.normal_()
        att_s.relative_position_bias_table.copy_(att_t.relative_position_bias_table)
        x = torch.randn(2, 30, 14, 16)
        np.testing.assert_allclose(to_numpy(att_t(x)),
                                   to_numpy(att_s(x.transpose(1, 2)).transpose(1, 2)),
                                   atol=1e-5)
        perm = torch.tensor([1, 0])
        np.testing.assert_allclose(to_numpy(att_t(x)[perm]), to_numpy(att_t(x[perm])),
                                   atol=1e-6)
