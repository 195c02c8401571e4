"""Plain PyTorch reference of the 3-stream GSTCAN (the notebook
``GSTCAN_UR_conv.ipynb`` of the reference repository): a points ST-GCAN
backbone, a motion ST-GCAN backbone over frame-to-frame differences of
(x, y), and a CNN-BiLSTM over the wearable sensor, their features
concatenated into a linear head.

The sensor encoder follows the notebook's ``CNN_BiLSTM``: two stages of
Conv1d(k=5, pad 2), BatchNorm, ReLU and MaxPool(2) over time, a
bidirectional single-layer LSTM of 64 units, the mean over time, BatchNorm,
a channel-attention MLP (C -> C/8 -> C, sigmoid gate) and a linear layer to
the class logits. The notebook's softmax after the head belongs to the loss
here (``rmsprop_step``); the forward returns logits.

Imports nothing but ``torch`` and the reference's own ``stgcan`` module.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from port_bench.reference.stgcan import Backbone, BatchNorm


class ChannelAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.attention = nn.Sequential(nn.Linear(channels, channels // 8), nn.ReLU(),
                                       nn.Linear(channels // 8, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attention(x)


class BiLSTMHead(nn.Module):
    def __init__(self, input_size: int, num_classes: int, hidden: int = 64):
        super().__init__()
        self.lstm1 = nn.LSTM(input_size, hidden, batch_first=True, bidirectional=True)
        self.batchnorm = BatchNorm(2 * hidden)
        self.channelattention = ChannelAttention(2 * hidden)
        self.fc = nn.Sequential(nn.Identity(), nn.Linear(2 * hidden, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.lstm1(x)[0].mean(dim=1)
        return self.fc(self.channelattention(self.batchnorm(out)))


class CNN(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.layer1 = nn.Sequential(nn.Conv1d(in_channels, 16, 5, padding=2), BatchNorm(16),
                                    nn.ReLU(), nn.MaxPool1d(2))
        self.layer2 = nn.Sequential(nn.Conv1d(16, 32, 5, padding=2), BatchNorm(32),
                                    nn.ReLU(), nn.MaxPool1d(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, T, S) -> (N, T // 4, 32)``."""
        return self.layer2(self.layer1(x.transpose(1, 2))).transpose(1, 2)


class CNNBiLSTM(nn.Module):
    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.cnn = CNN(in_channels)
        self.bilstm = BiLSTMHead(32, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bilstm(self.cnn(x))


class GSTCAN3(nn.Module):
    """``forward(skeleton (N, T, V, C), sensor (N, T, S)) -> (N, classes)``."""

    def __init__(self, cfg: dict):
        super().__init__()
        stages = [tuple(s) for s in cfg["stages"]]
        self.pts_stream = Backbone(cfg["in_channels"], stages)
        self.mot_stream = Backbone(2, stages)
        self.sensor = CNNBiLSTM(cfg["sensor_dim"], cfg["num_classes"])
        self.fcn = nn.Linear(2 * stages[-1][0] + cfg["num_classes"], cfg["num_classes"])

    def forward(self, skeleton: torch.Tensor, sensor: torch.Tensor) -> torch.Tensor:
        motion = skeleton[:, 1:, :, :2] - skeleton[:, :-1, :, :2]
        feats = [self.pts_stream(skeleton), self.mot_stream(motion), self.sensor(sensor)]
        return self.fcn(torch.cat(feats, dim=-1))


def build(cfg: dict) -> nn.Module:
    """The configuration file's model (``"model"`` section)."""
    return GSTCAN3(cfg)

