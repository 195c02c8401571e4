"""The blocks no registered model builds, against the JAX package's on the
CPU: the skeleton transformer's pre-norm, parallel and growth blocks and its
B2T block with LayerNorms (``models/skeleton_transformer.py``), and musa's
separable temporal block with an expansion and without a residual
(``models/musa.py``); and ``utils.import_class``.

Weights are seeded JAX variables (``random_init``; norms and ``w_qkv``
halved as in ``tests/test_torch_gen3_models.py``) carried into the port.
Eval mode, and train mode with every draw off (stochastic depth and
dropout at 0, DropGraph's ``keep_prob`` at 1; BatchNorm then uses the batch
statistics), at 2e-5 (two float32 CPU implementations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.models import musa as jax_musa
from fall_multimodal_tpu.models import skeleton_transformer as jax_st
from fall_multimodal_tpu_torch.graphs import build_adjacency
from fall_multimodal_tpu_torch.interop import (
    _conv1x1_inv,
    _conv_t_inv,
    _FlaxReader,
    _Writer,
    load_into,
)
from fall_multimodal_tpu_torch.models import musa, skeleton_transformer
from fall_multimodal_tpu_torch.utils import import_class
from torch_port_helpers import random_init, t, to_numpy
from test_torch_gen3_models import condition

torch.set_num_threads(1)

TOL = 2e-5
ARGS = dict(head_dim=4, n_heads=2, n_joints=14, seq_len=30)


def _attn_pair(w, theirs):
    w.attention(f"{theirs}.multi_head_spatial_self_attention", "spatial_attn")
    w.attention(f"{theirs}.multi_head_temporal_self_attention", "temporal_attn")


def _write_b2t_layernorm(w):
    _attn_pair(w, "b")
    for n in ("norm1", "norm2", "norm3"):
        w.layer_norm(f"b.{n}", n)
    w.ffn("b.feed_forward_network", "ffn")


def _write_prenorm(w):
    _attn_pair(w, "b")
    for n in ("norm1", "norm2", "norm3", "norm4"):
        w.layer_norm(f"b.{n}", n)
    w.ffn("b.feed_forward_network", "ffn")


def _write_parallel(w):
    _attn_pair(w, "b")
    w.layer_norm("b.norm1", "norm1")
    w.layer_norm("b.norm3", "norm3")
    w.ffn("b.feed_forward_network", "ffn")


def _write_growth(w):
    w.b2t_block("b.block", "block")
    w.dense("b.growth.0", "Dense_0")
    w.layer_norm("b.growth.2", "LayerNorm_0")


def _transformer_blocks(dropout):
    """name: (JAX block, port block, writer)."""
    return {
        "b2t_layernorm": (
            jax_st.B2TSpatialTemporalBlock(**ARGS, normalization="layernorm", sd_rate=0.0,
                                           ffn_dropout=dropout),
            skeleton_transformer.B2TSpatialTemporalBlock(16, **ARGS, normalization="layernorm",
                                                          ffn_dropout=dropout),
            _write_b2t_layernorm),
        "prenorm": (jax_st.PreNormBlock(**ARGS, ffn_dropout=dropout),
                    skeleton_transformer.PreNormBlock(16, **ARGS, ffn_dropout=dropout),
                    _write_prenorm),
        "parallel": (jax_st.ParallelB2TBlock(**ARGS, ffn_dropout=dropout),
                     skeleton_transformer.ParallelB2TBlock(16, **ARGS, ffn_dropout=dropout),
                     _write_parallel),
        "growth": (jax_st.GrowthBlock(**ARGS, growth=8),
                   skeleton_transformer.GrowthBlock(16, **ARGS, growth=8),
                   _write_growth),
    }


def _carry(jblock, port_block, write, x, *args):
    """The JAX block's seeded variables, written into the port block."""
    variables = condition(random_init(jblock, np.random.default_rng(7), jnp.asarray(x), *args,
                                      train=False))
    w = _Writer(_FlaxReader(variables["params"]),
                _FlaxReader(variables.get("batch_stats", {})))
    write(w)
    assert not (w.p.unused() | w.s.unused())
    load_into(port_block, {k[2:]: v for k, v in w.sd.items()})
    return variables


def _apply_both(jblock, port_block, variables, x, train, *jargs):
    if train:
        ref, _ = jblock.apply(variables, jnp.asarray(x), *jargs, train=True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
    else:
        ref = jblock.apply(variables, jnp.asarray(x), *jargs, train=False)
    port_block.train(train)
    with torch.no_grad():
        out = port_block(t(x), torch.Generator().manual_seed(0))
    return np.asarray(ref), to_numpy(out)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["b2t_layernorm", "prenorm", "parallel", "growth"])
def test_transformer_block_matches_jax(name, train):
    """5-D input (persons M = 2); the growth block widens 16 -> 24 channels.
    The growth block's inner B2T block keeps the reference's FFN dropout
    (0.5), so it is compared in eval mode and, in train mode, with that
    dropout's rate set to 0 on both sides."""
    jblock, port_block, write = _transformer_blocks(dropout=0.0)[name]
    if name == "growth" and train:
        port_block.block.feed_forward_network[3].p = 0.0
    x = np.random.default_rng(1).normal(size=(3, 2, 30, 14, 16)).astype(np.float32)
    variables = _carry(jblock, port_block, write, x)
    if name == "growth" and train:
        # the JAX GrowthBlock builds its B2TBlock with the default dropout;
        # run its train mode through the same block with the dropout off
        inner = jax_st.B2TBlock(4, 2, 14, ffn_dropout=0.0)
        y = inner.apply({"params": variables["params"]["block"]}, jnp.asarray(x), train=True)
        head = jax_st.nn.Dense(8).apply({"params": variables["params"]["Dense_0"]}, y)
        head = jax.nn.gelu(head, approximate=False)
        head = jax_st.nn.LayerNorm(epsilon=1e-5).apply(
            {"params": variables["params"]["LayerNorm_0"]}, head)
        ref = np.concatenate([x, np.asarray(head)], axis=-1)
        port_block.train()
        with torch.no_grad():
            ours = to_numpy(port_block(t(x), torch.Generator().manual_seed(0)))
    else:
        ref, ours = _apply_both(jblock, port_block, variables, x, train)
    assert ours.shape == ref.shape == ((3, 2, 30, 14, 24) if name == "growth" else x.shape)
    np.testing.assert_allclose(ours, ref, atol=TOL)


def _write_sep(w, expand, residual_proj):
    w.sd["b.A"] = build_adjacency("coco_cut", "uniform").astype(np.float32)
    w.sd["b.edge"] = w.p("edge")
    if expand:
        w.dense("b.expand_conv.0", "expand", inv=_conv1x1_inv)
        w.bn("b.expand_conv.1", "expand_bn")
    w.dense("b.depth_conv.0", "depthwise", inv=_conv_t_inv)
    w.bn("b.depth_conv.1", "depth_bn")
    w.dense("b.point_conv.0", "pointwise", inv=_conv1x1_inv)
    w.bn("b.point_conv.1", "point_bn")
    if residual_proj:
        w.dense("b.residual.0", "res_proj", inv=_conv1x1_inv)
        w.bn("b.residual.1", "res_bn")


SEP_CASES = {   # name: (expand_ratio, stride, residual)
    "expand2_stride1": (2, 1, True),
    "expand2_stride2": (2, 2, True),
    "no_residual": (0, 1, False),
    "expand2_stride2_no_residual": (2, 2, False),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", list(SEP_CASES))
def test_musa_sep_temporal_block_matches_jax(case, train):
    expand, stride, residual = SEP_CASES[case]
    kw = dict(temporal_window=5, stride=stride, expand_ratio=expand, act_type="relu",
              keep_prob=1.0, residual=residual)
    jblock = jax_musa.SepTemporalBlock(16, **kw)
    port_block = musa.SepTemporalBlock(16, **kw)
    x = np.random.default_rng(2).normal(size=(3, 30, 14, 16)).astype(np.float32)
    A = jnp.asarray(build_adjacency("coco_cut", "uniform").astype(np.float32))
    variables = _carry(jblock, port_block,
                       lambda w: _write_sep(w, expand, residual and stride != 1), x, A)
    ref, ours = _apply_both(jblock, port_block, variables, x, train, A)
    assert ours.shape == (3, 30 // stride, 14, 16)
    np.testing.assert_allclose(ours, ref, atol=TOL)


@pytest.mark.parametrize("name", ["b2t_layernorm", "prenorm", "parallel", "growth", "sep"])
def test_train_mode_draws_come_from_the_generator(name):
    """With dropout (0.5) and DropGraph (keep 0.9) on, a train-mode forward
    depends on the generator it is given and on nothing else: torch's
    global generator is not read."""
    if name == "sep":
        block = musa.SepTemporalBlock(16, 5, stride=2, expand_ratio=2, keep_prob=0.9,
                                      residual=False)
        x = torch.randn(3, 30, 14, 16, generator=torch.Generator().manual_seed(0))
    else:
        block = _transformer_blocks(dropout=0.5)[name][1]
        x = torch.randn(2, 30, 14, 16, generator=torch.Generator().manual_seed(0))
    block.train()
    before = torch.get_rng_state()
    with torch.no_grad():
        a, b, c = (block(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_import_class_resolves_a_dotted_path():
    assert import_class("fall_multimodal_tpu_torch.models.musa.SepTemporalBlock") \
        is musa.SepTemporalBlock
    with pytest.raises(ValueError, match="dotted path"):
        import_class("SepTemporalBlock")
