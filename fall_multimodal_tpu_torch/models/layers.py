"""Shared building blocks in the ``(N, T, V, C)`` / ``(N, T, C)`` layout.

PyTorch counterparts of ``fall_multimodal_tpu/models/layers.py``. Every
parameter keeps the reference torch name and shape (a 1x1 channel mix is a
``Conv2d`` weight ``(O, I, 1, 1)``, the temporal conv ``(O, I, 9, 1)``), so
reference checkpoints load with ``load_state_dict``; the forwards work
channel-last, as the JAX package does, so tensors compare directly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm1d):
    """Torch-default BatchNorm (momentum 0.1, eps 1e-5) over the LAST axis:
    statistics are taken over every leading axis, as flax's BatchNorm does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1])).reshape(shape)


class Conv1x1(nn.Conv2d):
    """A 1x1 ``Conv2d`` (reference parameter shapes) applied channel-last:
    ``(..., I) -> (..., O)``."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


class TemporalConv(nn.Conv2d):
    """(k, 1) convolution over the T axis of an ``(N, T, V, C)`` tensor,
    padding (k-1)/2, stride over T only (``layers.py:57-76``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, bias: bool = True):
        pad = (kernel_size - 1) // 2
        super().__init__(in_channels, out_channels, (kernel_size, 1),
                         stride=(stride, 1), padding=(pad, 0), bias=bias)

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
        W = self.conv.weight[:, :, 0, 0].t().reshape(c_in, k, c)
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


class BiLSTMLayer(nn.LSTM):
    """Bidirectional single-layer LSTM over ``(N, T, F) -> (N, T, 2H)``;
    ``out[:, t, :H]`` is the forward state at t, ``out[:, t, H:]`` the
    backward state at t (``layers.py:190-232``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]
