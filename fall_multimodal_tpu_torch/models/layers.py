"""Shared building blocks in the ``(N, T, V, C)`` / ``(N, T, C)`` layout.

PyTorch counterparts of ``fall_multimodal_tpu/models/layers.py``. Every
parameter keeps the reference torch name and shape (a 1x1 channel mix is a
``Conv2d`` weight ``(O, I, 1, 1)``, the temporal conv ``(O, I, 9, 1)``), so
reference checkpoints load with ``load_state_dict``; the forwards work
channel-last, as the JAX package does, so tensors compare directly.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def activation_factory(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activations of the reference factory (``musa_model.py:19-37``; JAX
    ``models/layers.py:20-39``): ``leakyrelu`` has slope 0.2, ``gelu`` is the
    exact erf form. The reference's ``acon``/``metaacon`` name classes it
    never defines; here they raise ``ValueError`` like any unknown name."""
    table = {
        "relu": torch.relu,
        "leakyrelu": lambda x: F.leaky_relu(x, 0.2),
        "tanh": torch.tanh,
        "gelu": F.gelu,
        "hardswish": F.hardswish,
        "linear": lambda x: x,
        None: lambda x: x,
    }
    if name not in table:
        raise ValueError(f"Not supported activation: {name}")
    return table[name]


def require_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The generator a train-mode draw takes; a draw never falls back to
    torch's global generator."""
    if generator is None:
        raise ValueError("a train-mode forward that draws (dropout, DropGraph, stochastic "
                         "depth) needs generator=<the train state's torch.Generator>")
    return generator


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from ``generator`` (the train
    state's), never from torch's global generator. Eval, or ``p == 0``, is
    the identity and draws nothing."""
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=require_generator(generator))
    return x * keep / (1.0 - p)


class Dropout(nn.Module):
    """:func:`dropout` as a module (no parameters: it holds a reference
    ``nn.Dropout``'s place in a ``Sequential``); ``forward(x, generator)``."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.p, self.training, generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def register_constant(module: nn.Module, name: str, value: torch.Tensor,
                      atol: float = 1e-5) -> None:
    """A buffer that the reference saves in its state_dict but that is a
    function of the config (an adjacency, a positional table): saved under
    its reference name, and a checkpoint whose value differs from the
    model's own by more than ``atol`` is refused when it is loaded."""
    module.register_buffer(name, value)

    def check(mod, state_dict, prefix, *args):
        key = prefix + name
        if key not in state_dict:
            return
        theirs = torch.as_tensor(state_dict[key]).detach().cpu().double()
        ours = getattr(mod, name).detach().cpu().double()
        if theirs.shape != ours.shape or not torch.allclose(theirs, ours, rtol=0, atol=atol):
            raise ValueError(f"checkpoint {key!r} differs from the constant the config "
                             f"builds ({tuple(ours.shape)}); wrong graph or seq_len?")

    module.register_load_state_dict_pre_hook(check)


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (momentum 0.1, eps 1e-5) whose train-mode update of
    the running statistics follows flax's ``BatchNorm``, and so the JAX
    package (``models/layers.py:42-54``): the running variance takes the
    biased batch variance (sum over n), where stock torch takes the unbiased
    one (over n - 1). The normalisation itself, the eval forward and the
    parameter and buffer names are torch's.

    ``stats_group``: a ``torch.distributed`` group of data-parallel ranks
    that each hold a slice of one batch (set for the span of a train step by
    :func:`~fall_multimodal_tpu_torch.parallel.mesh.global_batch_stats`). A
    train-mode forward then takes the statistics of the whole batch, summed
    across the group's ranks and differentiable through the sums, as one
    process would over the whole batch (torch's ``SyncBatchNorm`` keeps the
    unbiased running variance, so it is not used)."""

    stats_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.stats_group is not None:
            return self._global_forward(x)
        if x.dtype != self.running_mean.dtype and torch._C._functorch.is_batchedtensor(x):
            # functorch's batching rule takes no reduced-precision input beside
            # float32 statistics (autocast in the vmapped CV step): normalise
            # in float32 there
            x = x.float()
        # torch's fused update adds momentum * var * n/(n-1) to the running
        # variance: scaling a copy of it by n/(n-1) before the update and by
        # (n-1)/n after leaves momentum * var (biased), without another pass
        # over x (the copy: autograd keeps the tensor the update wrote)
        n = x.numel() // x.shape[1]
        unbias = n / max(n - 1, 1)
        running_var = self.running_var * unbias
        y = F.batch_norm(x, self.running_mean, running_var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            # copy_, not div(out=): it runs under torch.func.vmap on stacked
            # fold buffers (train/cv_vmapped.py)
            self.running_var.copy_(running_var / unbias)
        self.num_batches_tracked.add_(1)
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.stats_group
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        n = x.numel() // x.shape[1] * torch.distributed.get_world_size(group)
        # two passes over the moments, as F.batch_norm takes them: mean, then
        # the centred square sum (biased variance)
        mean = _AllReduceSum.apply(x.sum(dims), group) / n
        centred = x - mean.view(shape)
        var = _AllReduceSum.apply((centred * centred).sum(dims), group) / n
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)
        return y


class _AllReduceSum(torch.autograd.Function):
    """A sum across a ``torch.distributed`` group, differentiable: the
    gradient of every rank's input is the sum of the ranks' output
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(BatchNorm1d):
    """:class:`BatchNorm1d` over the LAST axis: statistics are taken over
    every leading axis, as flax's BatchNorm does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1])).reshape(shape)


class DenseConv2d(nn.Conv2d):
    """A ``Conv2d`` whose kernel spans its input window, which the JAX package
    holds as a flax ``Dense``: :func:`~fall_multimodal_tpu_torch.models.init.
    reinitialize` draws it as a linear."""


class Conv1x1(DenseConv2d):
    """A 1x1 ``Conv2d`` (reference parameter shapes) applied channel-last:
    ``(..., I) -> (..., O)``."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a view of the (O, I, 1, 1) weight: its backward allocates nothing
        return F.linear(x, self.weight.flatten(1), self.bias)


class TemporalConv(nn.Conv2d):
    """(k, 1) convolution over the T axis of an ``(N, T, V, C)`` tensor,
    padding (k-1)/2, stride over T only (``layers.py:57-76``); ``groups`` =
    channels makes it depthwise (weight ``(C, 1, k, 1)``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, bias: bool = True,
                 groups: int = 1):
        pad = (kernel_size - 1) // 2
        super().__init__(in_channels, out_channels, (kernel_size, 1),
                         stride=(stride, 1), padding=(pad, 0), bias=bias, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.permute(0, 3, 1, 2))          # (N, C, T, V)
        return y.permute(0, 2, 3, 1).contiguous()


class GraphConv(nn.Module):
    """Spatial graph convolution (reference ``Model/stgcan.py:50-56``):
    1x1 channel mix to K partitions (``conv``, weight ``(K*C, Cin, 1, 1)``,
    k-major like the reference ``view(n, K, C, t, v)``), then the
    A-contraction ``out[n,t,w,c] = sum_{k,v} mix(x)[n,t,v,k,c] A[k,v,w]``.

    ``dense_mode`` computes the same function as one matmul
    ``(N*T, V*Cin) @ U`` with ``U[(v,i),(w,c)] = sum_k A[k,v,w] W[i,k,c]``,
    folded on the fly from the same parameters (``layers.py:101-156``).
    """

    def __init__(self, in_channels: int, out_channels: int, num_partitions: int,
                 bias: bool = True, dense_mode: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.num_partitions = num_partitions
        self.dense_mode = dense_mode
        self.conv = Conv1x1(in_channels, out_channels * num_partitions, bias=bias)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        n, t, v, c_in = x.shape
        k, c = self.num_partitions, self.out_channels
        if v != A.shape[1]:
            raise ValueError(
                f"GraphConv: input has V={v} joints but the graph adjacency "
                f"is (K={A.shape[0]}, V={A.shape[1]}) — the dataset's joint "
                "count must match graph.layout")
        if not self.dense_mode:
            y = self.conv(x).reshape(n, t, v, k, c)
            return torch.einsum("ntvkc,kvw->ntwc", y, A)
        W = self.conv.weight.flatten(1).t().reshape(c_in, k, c)
        U = torch.einsum("kvw,ikc->viwc", A, W).reshape(v * c_in, v * c)
        y = x.reshape(n, t, v * c_in) @ U
        if self.conv.bias is not None:
            b_eff = torch.einsum("kvw,kc->wc", A, self.conv.bias.reshape(k, c))
            y = y + b_eff.reshape(v * c)
        return y.reshape(n, t, v, c)


class SqueezeExcite(nn.Module):
    """GSTCAN channel attention (reference ``Model/stgcan.py:59-74``):
    global mean over (T, V) -> 1x1 (C -> C/4) -> BN -> ReLU -> 1x1 -> sigmoid
    gate. ``atten`` keeps the reference indices: 0 pool, 1 conv, 2 BN,
    3 ReLU, 4 conv, 5 sigmoid."""

    def __init__(self, channels: int):
        super().__init__()
        hidden = channels // 4
        self.atten = nn.Sequential(
            nn.Identity(),                    # AdaptiveAvgPool2d slot; pooled in forward
            Conv1x1(channels, hidden),
            BatchNorm(hidden),
            nn.ReLU(),
            Conv1x1(hidden, channels),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.atten(x.mean(dim=(1, 2)))                 # (N, C)
        return x * a[:, None, None, :]


class MlpChannelAttention(nn.Module):
    """Sensor-head channel attention (reference ``Model/bilstm.py:5-19``):
    Linear(C -> C/8) -> ReLU -> Linear -> sigmoid, elementwise gate."""

    def __init__(self, channels: int, reduce_rate: float = 1.0 / 8.0):
        super().__init__()
        hidden = int(channels * reduce_rate)
        self.attention = nn.Sequential(
            nn.Linear(channels, hidden), nn.ReLU(),
            nn.Linear(hidden, channels), nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attention(x)


def _bilstm(x: torch.Tensor, weights) -> torch.Tensor:
    """One bidirectional single-layer LSTM, batch first, zero initial state;
    ``weights`` in ``nn.LSTM._flat_weights`` order."""
    h0 = x.new_zeros(2, x.shape[0], weights[1].shape[1])
    return torch.lstm(x, (h0, h0), list(weights), True, 1, 0.0, torch.is_grad_enabled(),
                      True, True)[0]


class _FoldBatchedBiLSTM(torch.autograd.Function):
    """:func:`_bilstm` with a rule of its own under ``torch.func.vmap``:
    ``aten::lstm`` has no batching rule, so a vmap over stacked models (the
    folds of :mod:`~fall_multimodal_tpu_torch.train.cv_vmapped`) runs one
    LSTM per slice of the vmapped axis, each on its own weights, and stacks
    the outputs: exact against a model run alone, one cuDNN call per fold
    forward and one backward. Autograd differentiates those calls
    directly; :meth:`backward` serves a call outside vmap, by recomputing."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, *weights):
        return _bilstm(x, weights)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _bilstm(inputs[0], inputs[1:])
        return torch.autograd.grad(out, inputs, grad)

    @staticmethod
    def vmap(info, in_dims, x, *weights):
        def part(t, dim, i):
            return t if dim is None else t.select(dim, i)

        with warnings.catch_warnings():
            # a slice of stacked weights is not cuDNN's flat buffer: each call
            # packs its fold's weights (~50k floats) first, as it warns
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            outs = [_bilstm(part(x, in_dims[0], i),
                            [part(w, d, i) for w, d in zip(weights, in_dims[1:])])
                    for i in range(info.batch_size)]
        return torch.stack(outs), 0


class BiLSTMLayer(nn.LSTM):
    """Bidirectional single-layer LSTM over ``(N, T, F) -> (N, T, 2H)``;
    ``out[:, t, :H]`` is the forward state at t, ``out[:, t, H:]`` the
    backward state at t (``layers.py:190-232``). Under ``torch.func.vmap``
    (stacked fold states) it runs one LSTM per fold
    (:class:`_FoldBatchedBiLSTM`); otherwise it is ``nn.LSTM``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # by name: torch.func.functional_call swaps the parameters in without
        # touching nn.LSTM's cached _flat_weights
        weights = [getattr(self, name) for name in self._flat_weights_names]
        if any(map(torch._C._functorch.is_batchedtensor, (x, *weights))):
            return _FoldBatchedBiLSTM.apply(x, *weights)
        return super().forward(x)[0]
