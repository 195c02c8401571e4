"""Wearable-sensor encoders in PyTorch: BiLSTM, 1D-CNN, CNN+BiLSTM.

Counterparts of ``fall_multimodal_tpu/models/sensors.py:24-96`` with the
reference names (``Model/bilstm.py:21-59``; notebook ``GSTCAN_UR_conv.ipynb:2``
``CNN1D``/``CNN_BiLSTM``). Inputs are ``(N, T, S)`` windows, outputs
``(N, num_classes)`` logits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.models.layers import BiLSTMLayer, MlpChannelAttention


class BiLSTMHead(nn.Module):
    """``lstm1`` -> (last | mean) pool -> ``batchnorm`` -> ``channelattention``
    -> ``fc.1``. ``feature="mean"`` is what every fusion config uses."""

    def __init__(self, input_size: int, num_classes: int, hidden_size: int = 64,
                 feature: str = "mean"):
        super().__init__()
        if feature not in ("last", "mean"):
            raise ValueError(f"feature must be 'last' or 'mean', got {feature!r}")
        self.feature = feature
        self.lstm1 = BiLSTMLayer(input_size, hidden_size)
        self.batchnorm = nn.BatchNorm1d(2 * hidden_size)
        self.channelattention = MlpChannelAttention(2 * hidden_size)
        # index 0 is the reference's dropout slot; the JAX head has no dropout
        self.fc = nn.Sequential(nn.Identity(), nn.Linear(2 * hidden_size, num_classes))

    def forward(self, sensor: torch.Tensor) -> torch.Tensor:
        out = self.lstm1(sensor)
        out = out[:, -1, :] if self.feature == "last" else out.mean(dim=1)
        return self.fc(self.channelattention(self.batchnorm(out)))


class Cnn1d(nn.Module):
    """Two Conv1d(k=5)/BN/ReLU/MaxPool(2) stages over time:
    ``(N, T, S) -> (N, T/4, 32)``.

    The reference ``CNN1D`` also defines a flatten+Linear ``fc`` (32x224)
    that its forward never calls. It is not built here; the checkpoint
    loader drops exactly ``sensor.cnn.fc.weight`` and ``sensor.cnn.fc.bias``
    by name (``interop.DEAD_REFERENCE_KEYS``).
    """

    def __init__(self, in_channels: int, channels: tuple = (16, 32)):
        super().__init__()
        c1, c2 = channels
        self.layer1 = self._stage(in_channels, c1)
        self.layer2 = self._stage(c1, c2)

    @staticmethod
    def _stage(cin: int, cout: int) -> nn.Sequential:
        return nn.Sequential(nn.Conv1d(cin, cout, 5, padding=2),
                             nn.BatchNorm1d(cout), nn.ReLU(), nn.MaxPool1d(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layer2(self.layer1(x.transpose(1, 2)))
        return y.transpose(1, 2)


class CnnBiLSTMHead(nn.Module):
    """CNN trunk then BiLSTM head (reference ``CNN_BiLSTM``; its 64-unit
    BiLSTM over the 32-channel conv features is hardcoded there too)."""

    def __init__(self, input_size: int, num_classes: int, hidden_size: int = 64,
                 feature: str = "mean"):
        super().__init__()
        self.cnn = Cnn1d(input_size)
        self.bilstm = BiLSTMHead(32, num_classes, hidden_size, feature)

    def forward(self, sensor: torch.Tensor) -> torch.Tensor:
        return self.bilstm(self.cnn(sensor))


def build_sensor_encoder(kind: Optional[str], input_size: int, num_classes: int,
                         feature: str = "mean") -> nn.Module:
    if kind in ("bilstm", "lstm"):
        return BiLSTMHead(input_size, num_classes, feature=feature)
    if kind in ("cnn_bilstm", "cnn"):
        return CnnBiLSTMHead(input_size, num_classes, feature=feature)
    raise ValueError(f"Unknown sensor encoder: {kind!r}")
