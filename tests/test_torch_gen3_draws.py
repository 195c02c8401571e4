"""The train-mode draws of the Gen-3 and Gen-1 families in the port:
DropGraph, stochastic depth, dropout, and where they come from.

``jax.random`` and ``torch.Generator`` cannot give the same draws, so the
draws are held by distribution and by their deterministic parts: the port's
DropBlockSke / DropBlockT over 2,000 draws against the reference's sampling
statistics (``reference_dropblock.npz``) at ``tests/test_aux.py:166-225``'s
tolerances (drop fraction 0.008, mean rescale 0.02, per-joint frequency
0.04); the temporal widening against a numpy restatement; the JAX
package's ``fused_dropgraph`` switch as a no-op; stochastic depth and dropout by
their keep rate and 1/(1-p) scale; and every draw of a train-mode forward
from the generator it is given, none from torch's global generator.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.models import musa, skeleton_transformer
from fall_multimodal_tpu_torch.models.init import reinitialize
from fall_multimodal_tpu_torch.models.layers import dropout
from torch_port_helpers import t, to_numpy

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def test_dropgraph_statistics_match_reference():
    """2,000 draws of the port's DropBlockSke and DropBlockT (block 7) on the
    reference's fixed input: drop fraction (0.008), mean rescale (0.02),
    per-(sample, joint) drop frequency (0.04), as ``test_aux.py`` holds the
    JAX modules."""
    blob = np.load(os.path.join(FIX, "reference_dropblock.npz"))
    x = t(np.transpose(blob["x"], (0, 2, 3, 1)))             # NCTV -> NTVC
    A = t(blob["A"])
    draws, keep_prob = int(blob["draws"]), float(blob["keep_prob"])
    g = torch.Generator().manual_seed(42)
    ske_dropped, ske_scale, t_dropped, t_scale = [], [], [], []
    for _ in range(draws):
        out = musa.drop_block_ske(x, keep_prob, A, g)
        ske_dropped.append((out == 0).all(dim=3).all(dim=1))  # (N, V)
        ske_scale.append((out / x)[out != 0].mean())
        out = musa.drop_block_t(x, keep_prob, 7, g)
        t_dropped.append((out == 0).all(dim=3).all(dim=2))    # (N, T)
        t_scale.append((out / x)[out != 0].mean())
    ske = torch.stack(ske_dropped).float()
    np.testing.assert_allclose(float(ske.mean()), blob["ske_frac_mean"], atol=0.008)
    np.testing.assert_allclose(float(torch.stack(ske_scale).mean()), blob["ske_scale_mean"],
                               atol=0.02)
    np.testing.assert_allclose(to_numpy(ske.mean(dim=0)), blob["ske_pos_freq"], atol=0.04)
    np.testing.assert_allclose(float(torch.stack(t_dropped).float().mean()),
                               blob["t_frac_mean"], atol=0.008)
    np.testing.assert_allclose(float(torch.stack(t_scale).mean()), blob["t_scale_mean"],
                               atol=0.02)


@pytest.mark.parametrize("block", [7, 41])
def test_dropgraph_widening_is_a_zero_padded_window_max(block):
    """The temporal widening: a max over ``block`` frames centred on each
    frame, padded with 0 as the reference pads (``max_pool1d`` pads with
    -inf; the clamp makes them agree), cut to T, also when the window is
    wider than T = 30."""
    rng = np.random.default_rng(block)
    m = (rng.random((5, 30)) < 0.08).astype(np.float32)
    pad = block // 2
    mp = np.pad(m, ((0, 0), (pad, pad)))
    ref = np.stack([mp[:, i:i + block].max(axis=1) for i in range(30)], axis=1)
    np.testing.assert_array_equal(to_numpy(musa._widen(t(m), block)), ref)


def test_fused_dropgraph_is_accepted_and_changes_nothing():
    """``fused_dropgraph`` picks an XLA formulation in the JAX package; the
    port takes it from a preset's kwargs and computes the same function: the
    same weights and generator seed give the same train-mode output."""
    cfg = load_config(preset_path("musa_harup"))
    outs = []
    for fused in (False, True):
        kwargs = dict(cfg.model.kwargs, embed_dim=16, fused_dropgraph=fused)
        c = cfg.replace(model=dataclasses.replace(cfg.model, kwargs=kwargs))
        model = reinitialize(build_model(c), seed=0).train()
        skel = t(np.random.default_rng(0).normal(size=(4, 30, 14, 3)))
        with torch.no_grad():
            outs.append(model(skel, generator=torch.Generator().manual_seed(5)))
    assert torch.equal(outs[0], outs[1])


def test_stochastic_depth_and_dropout_rates():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(64, 32)
    kept = [float(skeleton_transformer.stochastic_depth(x, 0.3, True, g)[0, 0])
            for _ in range(4000)]
    kept = np.asarray(kept)
    assert set(np.round(kept, 5)) == {0.0, round(1 / 0.7, 5)}
    np.testing.assert_allclose((kept > 0).mean(), 0.7, atol=0.025)
    y = torch.ones(400, 500)
    out = dropout(y, 0.2, True, g)
    assert set(np.round(np.unique(to_numpy(out)), 5)) == {0.0, 1.25}
    np.testing.assert_allclose(float((out > 0).float().mean()), 0.8, atol=0.005)
    assert dropout(y, 0.2, False, None) is y
    with pytest.raises(ValueError, match="generator"):
        dropout(y, 0.2, True, None)


@pytest.mark.parametrize("preset,kwargs", [
    ("musa_harup", {"embed_dim": 16}),
    ("skeleton_transformer_harup", {"embedding_dim": 16, "n_block": 3}),
    ("transformer_ensemble_harup", {"embedding_dim": 16, "n_block": 3}),
], ids=["musa", "skeleton_transformer", "transformer_ensemble"])
def test_train_mode_draws_come_from_the_generator(preset, kwargs):
    """A train-mode forward draws from the generator it is given and from
    nothing else: one seed gives one output twice, whatever is drawn from
    torch's global generator in between; another seed another output; and
    the global generator's state is untouched."""
    cfg = load_config(preset_path(preset))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                kwargs=dict(cfg.model.kwargs, **kwargs)))
    model = reinitialize(build_model(cfg), seed=0).train()
    rng = np.random.default_rng(0)
    d = cfg.data
    skel = t(rng.normal(size=(4, d.seq_len, d.num_joints, d.in_channels)))
    sensor = t(rng.normal(size=(4, d.seq_len, max(d.sensor_dim, 1))))

    def run(seed):
        with torch.no_grad():
            return model(skel, sensor, generator=torch.Generator().manual_seed(seed))

    first = run(1)
    torch.rand(1000)
    before = torch.get_rng_state()
    again, other = run(1), run(2)
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(first, again)
    assert (first - other).abs().max() > 1e-4
    with pytest.raises(ValueError, match="generator"):
        model(skel, sensor)


def _published_dropgraph(x, keep_prob, A, block_size, g):
    """``drop_block_t(drop_block_ske(x))`` as ``musa_model.py:39-98`` writes
    it, channel-last: each mask applied, then its rescale."""
    n, t_, v, c = x.shape
    act = x.detach().abs().mean(dim=(1, 3))
    act = act / act.sum() * act.numel()
    seed = torch.bernoulli((act * ((1.0 - keep_prob) / (1.0 + 1.92))).clamp(0.0, 1.0),
                           generator=g)
    mask = 1.0 - ((seed @ A) > 0.001).float()
    x = x * mask[:, None, :, None] * (mask.numel() / mask.sum().clamp(min=1.0))
    act = x.detach().abs().mean(dim=(2, 3))
    act = act / act.sum() * act.numel()
    m = torch.bernoulli((act * ((1.0 - keep_prob) / block_size)).clamp(0.0, 1.0), generator=g)
    perm = torch.randperm(t_, generator=g)
    mask = 1.0 - musa._widen(m, block_size)[:, perm]
    return x * mask[:, :, None, None] * (mask.numel() / mask.sum().clamp(min=1.0))


@pytest.mark.parametrize("frames", [30, 15])
def test_dropgraph_factors_equal_the_published_composition_bit_for_bit(frames):
    """A block's DropGraph multiplies each branch by two factors, made from
    the branch's ``|x|``: the published ske-then-t composition bit for bit,
    forward and gradient, on the main branch and then the residual, four
    times over, with the generator left in the same state."""
    block = musa.SepTemporalBlock(16, 3, 1, act_type="tanh", keep_prob=0.7,
                                  block_size=41).train()
    with torch.no_grad():
        block.edge.mul_(1.0 + 0.2 * torch.rand(block.edge.shape,
                                               generator=torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(frames)
    main, res = (t(rng.normal(size=(6, frames, 14, 16))).requires_grad_() for _ in range(2))
    g_block, g_pub = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for _ in range(4):
        got = block.drop(g_block, main, res)
        want = [_published_dropgraph(z, 0.7, block.graph().detach()[0], 41, g_pub)
                for z in (main, res)]
        assert torch.equal(g_block.get_state(), g_pub.get_state())
        for a, b, z in zip(got, want, (main, res)):
            assert torch.equal(a, b) and 0 < int((a == 0).sum()) < a.numel()
            ga, = torch.autograd.grad(a.square().sum(), z)
            gb, = torch.autograd.grad(b.square().sum(), z)
            assert torch.equal(ga, gb)
