"""Port layers (``fall_multimodal_tpu_torch.models.layers``) against their
flax counterparts on shared weights and shared numpy inputs.

Tolerance 2e-5: two float32 CPU implementations of the same arithmetic,
summed in different orders (the same bar the JAX package holds its layers
to against the reference torch code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.graphs import build_adjacency
from fall_multimodal_tpu.models import layers as jl
from fall_multimodal_tpu_torch.interop import _conv1x1_inv, _conv_t_inv, _dense_inv
from fall_multimodal_tpu_torch.models import layers as tl
from torch_port_helpers import random_init, t, to_numpy

torch.set_num_threads(1)
TOL = 2e-5


def _bn_into(bn, p, s):
    bn.weight.data = t(p["scale"])
    bn.bias.data = t(p["bias"])
    bn.running_mean.data = t(s["mean"])
    bn.running_var.data = t(s["var"])


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm(rng, train):
    x = rng.normal(size=(4, 6, 14, 8)).astype(np.float32)
    v = random_init(jl.BatchNorm(), rng, jnp.asarray(x), train=False)
    ref = jl.BatchNorm().apply(v, jnp.asarray(x), train=train,
                               mutable=["batch_stats"] if train else False)
    ref = ref[0] if train else ref
    bn = tl.BatchNorm(8)
    _bn_into(bn, v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"])
    bn.train(train)
    with torch.no_grad():
        ours = bn(t(x))
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_temporal_conv(rng, stride):
    x = rng.normal(size=(3, 29, 14, 8)).astype(np.float32)
    mod = jl.TemporalConv(features=12, kernel_size=9, stride=stride)
    v = random_init(mod, rng, jnp.asarray(x))
    ref = mod.apply(v, jnp.asarray(x))
    conv = tl.TemporalConv(8, 12, 9, stride)
    conv.weight.data = t(_conv_t_inv(v["params"]["Conv_0"]["kernel"]))
    conv.bias.data = t(v["params"]["Conv_0"]["bias"])
    with torch.no_grad():
        ours = conv(t(x))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("dense_mode", [False, True])
def test_graph_conv(rng, dense_mode):
    x = rng.normal(size=(3, 10, 14, 5)).astype(np.float32)
    A = build_adjacency("coco_cut", "spatial").astype(np.float32)
    A = A * (1 + 0.1 * rng.normal(size=A.shape)).astype(np.float32)
    mod = jl.GraphConv(features=16, dense_mode=dense_mode)
    v = random_init(mod, rng, jnp.asarray(x), jnp.asarray(A))
    ref = mod.apply(v, jnp.asarray(x), jnp.asarray(A))
    gc = tl.GraphConv(5, 16, 3, dense_mode=dense_mode)
    gc.conv.weight.data = t(_conv1x1_inv(v["params"]["Dense_0"]["kernel"]))
    gc.conv.bias.data = t(v["params"]["Dense_0"]["bias"])
    with torch.no_grad():
        ours = gc(t(x), t(A))
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=TOL)


def test_squeeze_excite(rng):
    x = rng.normal(size=(4, 8, 14, 16)).astype(np.float32)
    v = random_init(jl.SqueezeExcite(), rng, jnp.asarray(x), train=False)
    ref = jl.SqueezeExcite().apply(v, jnp.asarray(x), train=False)
    se = tl.SqueezeExcite(16).eval()
    p, s = v["params"], v["batch_stats"]
    for idx, name in ((1, "Dense_0"), (4, "Dense_1")):
        se.atten[idx].weight.data = t(_conv1x1_inv(p[name]["kernel"]))
        se.atten[idx].bias.data = t(p[name]["bias"])
    _bn_into(se.atten[2], p["BatchNorm_0"]["BatchNorm_0"], s["BatchNorm_0"]["BatchNorm_0"])
    with torch.no_grad():
        ours = se(t(x))
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=TOL)


def test_mlp_channel_attention(rng):
    x = rng.normal(size=(5, 128)).astype(np.float32)
    v = random_init(jl.MlpChannelAttention(), rng, jnp.asarray(x))
    ref = jl.MlpChannelAttention().apply(v, jnp.asarray(x))
    att = tl.MlpChannelAttention(128)
    for idx, name in ((0, "Dense_0"), (2, "Dense_1")):
        att.attention[idx].weight.data = t(_dense_inv(v["params"][name]["kernel"]))
        att.attention[idx].bias.data = t(v["params"][name]["bias"])
    with torch.no_grad():
        ours = att(t(x))
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=TOL)


def test_bilstm_layer(rng):
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    v = random_init(jl.BiLSTMLayer(hidden_size=8), rng, jnp.asarray(x))
    ref = jl.BiLSTMLayer(hidden_size=8).apply(v, jnp.asarray(x))
    lstm = tl.BiLSTMLayer(6, 8)
    for direction, tag in (("fwd", ""), ("bwd", "_reverse")):
        for gate in ("ih", "hh"):
            cell = v["params"][direction][gate]
            getattr(lstm, f"weight_{gate}_l0{tag}").data = t(_dense_inv(cell["kernel"]))
            getattr(lstm, f"bias_{gate}_l0{tag}").data = t(cell["bias"])
    with torch.no_grad():
        ours = lstm(t(x))
    assert ours.shape == (3, 7, 16)
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=TOL)
