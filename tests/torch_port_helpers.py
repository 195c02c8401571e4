"""Shared helpers of the ``test_torch_*`` files: seeded random flax
variables (numpy leaves) and conversions between the two packages. JAX is
imported inside the helpers that need it, so that the card-only tests,
which run where JAX is not installed, can import this module."""

import numpy as np
import pytest
import torch


def random_init(module, rng, *args, **kw):
    """Seeded variables of ``module`` shaped by its init (``jax.eval_shape``,
    no init is run) and scaled like a trained network: kernels ~ N(0, 2/fan_in),
    small biases, BN affines near identity with non-trivial statistics, edge
    importance near 1. Activations stay O(1) through a deep stack."""
    import jax

    def leaf(path, x):
        name, shape = path[-1].key, tuple(x.shape)
        z = rng.normal(size=shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            out = z * np.sqrt(2.0 / fan_in)
        elif name in ("scale", "var"):
            out = 1 + 0.3 * np.abs(z)
        elif name.startswith("edge_importance"):
            out = 1 + 0.1 * z
        else:                                   # biases and BN means
            out = 0.1 * z
        return out.astype(np.float32)

    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kw))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def port_block(variables, cin, cout, stride, residual):
    """A port ``STGCANBlock`` (eval) carrying a flax block's variables."""
    from fall_multimodal_tpu_torch.interop import _FlaxReader, _Writer, load_into
    from fall_multimodal_tpu_torch.models.stgcan import STGCANBlock

    block = STGCANBlock(cin, cout, 3, stride=stride, residual=residual)
    w = _Writer(_FlaxReader(variables["params"]), _FlaxReader(variables["batch_stats"]))
    w.block("b", proj=block.residual_mode == "proj")
    return load_into(block, {k[2:]: v for k, v in w.sd.items()}).eval()
