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
Norm layers keep scale 1 and bias 0; custom parameters (edge importance)
keep their construction-time values.

A 1x1 channel mix (``Conv2d`` ``(O, I, 1, 1)``), the temporal conv
``(O, I, 9, 1)`` and the sensor ``Conv1d`` ``(O, I, 5)`` have the fans of
their flax kernels. A 1x1 channel mix is a flax ``Dense`` in the JAX
package, so ``"init_param"`` draws it as a linear, as the JAX package does.
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

from fall_multimodal_tpu_torch.models.layers import Conv1x1

SCHEMES = ("torch", "init_param", "flax")

# 1 / std of a standard normal truncated to [-2, 2] (flax/jax
# variance_scaling's "truncated_normal" constant)
_TRUNC_STD = 0.87962566103423978


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
    """Re-draw every convolution, linear and LSTM parameter of ``model`` in
    place under ``scheme``; everything else is left as it is."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown weight_init scheme {scheme!r}; one of {SCHEMES}")
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(module, nn.LSTM):
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
                if module.weight.dim() >= 3 and not isinstance(module, Conv1x1):
                    _draw(w_name, module.weight, seed, "normal", std=math.sqrt(2.0 / fan_out))
                else:
                    _draw(w_name, module.weight, seed, "normal", std=0.001)
            else:  # flax: lecun_normal
                _draw(w_name, module.weight, seed, "truncated", std=1.0 / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
    return model
