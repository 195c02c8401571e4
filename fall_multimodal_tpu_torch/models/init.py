"""Seeded weight initialization under the JAX package's named schemes
(counterpart of ``fall_multimodal_tpu/models/init.py:68-131``).

The reference trains every model from torch module *defaults* — its
``init_param`` helper (``Multimodal_Fall3/model/musa_model.py:408-420``) is
defined but never called. The schemes, per leaf kind:

- ``"torch"``: convolutions and linears ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``
  on weight and bias (``kaiming_uniform_(a=sqrt(5))`` and torch's bias rule);
- ``"init_param"``: convolutions ``N(0, 2/fan_out)`` (kaiming_normal,
  fan_out, leaky_relu a=0), linears ``N(0, 0.001^2)``, biases 0;
- ``"flax"``: flax's defaults, lecun_normal kernels (a normal truncated at
  two standard deviations, scaled to variance ``1/fan_in``) and zero biases.

Under every scheme but ``"flax"`` an LSTM's weights and biases are
``U(-1/sqrt(H), 1/sqrt(H))``, as torch's ``nn.LSTM`` draws them; under
``"flax"`` its input and hidden matrices are lecun_normal over their own
fan-in and its biases zero, as the JAX package's flax ``Dense`` cells are.
Norm layers keep scale 1 and bias 0 (LayerNorms are reset to it). The
custom parameters keep the JAX package's construction-time initializers
(its ``models/init.py:23-25``) under every scheme: edge importance and the
Gen-3 ``edge`` masks stay ones; TARGCN's ``weights_pool``, ``bias_pool`` and
``node_embeddings`` are drawn N(0, 1); a ``relative_position_bias_table``
is flax's ``truncated_normal(0.02)``, a standard normal truncated to [-2, 2]
times 0.02.

A 1x1 channel mix (``Conv2d`` ``(O, I, 1, 1)``), the temporal conv
``(O, I, 9, 1)``, a depthwise conv ``(C, 1, k, 1)``, TARGCN's ``(T, T, 1,
3)`` attention convs and the sensor ``Conv1d`` ``(O, I, 5)`` have the fans
of their flax kernels. A 1x1 channel mix and TARGCN's ``end_conv`` (a
:class:`~fall_multimodal_tpu_torch.models.layers.DenseConv2d`) are flax
``Dense`` kernels in the JAX package, so ``"init_param"`` draws them as
linears, as the JAX package does.
Each parameter is drawn from its own ``torch.Generator`` seeded from the
run's seed and the parameter's state_dict name, on the CPU, so the draw does
not depend on the order of the parameters or on the device.
It cannot equal ``jax.random``'s draw; the distributions are the same.
"""

from __future__ import annotations

import math
import zlib

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.models.layers import DenseConv2d

SCHEMES = ("torch", "init_param", "flax")

# 1 / std of a standard normal truncated to [-2, 2] (flax/jax
# variance_scaling's "truncated_normal" constant)
_TRUNC_STD = 0.87962566103423978
# custom parameters by name: (kind, std) of the JAX package's initializer
_CUSTOM = {
    "weights_pool": ("normal", 1.0),
    "bias_pool": ("normal", 1.0),
    "node_embeddings": ("normal", 1.0),
    # flax truncated_normal(0.02): the truncated draw times 0.02, not rescaled
    "relative_position_bias_table": ("truncated", 0.02 * _TRUNC_STD),
}


def _fans(weight: torch.Tensor):
    """(fan_in, fan_out) as torch's ``_calculate_fan_in_and_fan_out``."""
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _generator(seed: int, name: str) -> torch.Generator:
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2 ** 63))


def _draw(name: str, param: torch.Tensor, seed: int, kind: str, bound: float = 0.0,
          std: float = 0.0) -> None:
    gen = _generator(seed, name)
    shape = tuple(param.shape)
    if kind == "uniform":
        value = (2 * torch.rand(shape, generator=gen) - 1) * bound
    elif kind == "normal":
        value = std * torch.randn(shape, generator=gen)
    else:  # truncated normal at +-2 std, then scaled
        value = torch.empty(shape)
        nn.init.trunc_normal_(value, 0.0, 1.0, -2.0, 2.0, generator=gen)
        value = value * (std / _TRUNC_STD)
    with torch.no_grad():
        param.copy_(value.to(param.dtype))


@torch.no_grad()
def reinitialize(model: nn.Module, seed: int, scheme: str = "torch") -> nn.Module:
    """Re-draw every convolution, linear and LSTM parameter and every custom
    parameter of ``model`` in place under ``scheme``, and reset LayerNorms;
    everything else is left as it is."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown weight_init scheme {scheme!r}; one of {SCHEMES}")
    for name, param in model.named_parameters():
        custom = _CUSTOM.get(name.rsplit(".", 1)[-1])
        if custom is not None:
            _draw(name, param, seed, custom[0], std=custom[1])
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LSTM):
            hidden = module.hidden_size
            for name, param in module.named_parameters(recurse=False):
                full = prefix + name
                if scheme != "flax":
                    _draw(full, param, seed, "uniform", bound=1.0 / math.sqrt(hidden))
                elif name.startswith("weight"):
                    _draw(full, param, seed, "truncated", std=1.0 / math.sqrt(param.shape[1]))
                else:
                    param.zero_()
        elif isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in, fan_out = _fans(module.weight)
            w_name = prefix + "weight"
            if scheme == "torch":
                bound = 1.0 / math.sqrt(fan_in)
                _draw(w_name, module.weight, seed, "uniform", bound=bound)
                if module.bias is not None:
                    _draw(prefix + "bias", module.bias, seed, "uniform", bound=bound)
                continue
            if scheme == "init_param":
                if module.weight.dim() >= 3 and not isinstance(module, DenseConv2d):
                    _draw(w_name, module.weight, seed, "normal", std=math.sqrt(2.0 / fan_out))
                else:
                    _draw(w_name, module.weight, seed, "normal", std=0.001)
            else:  # flax: lecun_normal
                _draw(w_name, module.weight, seed, "truncated", std=1.0 / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
    return model


def seeded_model(config, seed: int = 0, n: int = 64) -> nn.Module:
    """``config``'s model with weights drawn by :func:`reinitialize` (torch
    scheme) from ``seed``, conditioned as a trained network's are, in eval
    mode. Card-vs-CPU comparisons of served logits use it.

    TARGCN's pools are N(0, 1) (the reference's init): a node's weights
    ``E @ pool`` then have variance ``embed_dim``, the gates saturate and the
    30-step recurrence amplifies float32 rounding to 5e-2 of the logits.
    They are scaled here to variance 1/fan_in, as a He-initialised layer's.
    The BatchNorm running statistics come from one train-mode forward over
    ``n`` seeded normal windows (momentum 1), so that the eval forward
    normalises as a trained network's does and activations stay O(1)
    through deep residual stacks.
    """
    from fall_multimodal_tpu_torch.models.registry import build_model

    model = reinitialize(build_model(config), seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weights_pool"):
                p.mul_((p.shape[0] * p.shape[1]) ** -0.5)
            elif name.endswith("bias_pool"):
                p.mul_(0.1 * p.shape[0] ** -0.5)
    d = config.data
    gen = torch.Generator().manual_seed(seed)
    skel = torch.randn((n, d.seq_len, d.num_joints, d.in_channels), generator=gen)
    sensor = torch.randn((n, d.seq_len, max(d.sensor_dim, 1)), generator=gen)
    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(skel, sensor, generator=gen)
    for m in norms:
        m.momentum = 0.1
    return model.eval()
