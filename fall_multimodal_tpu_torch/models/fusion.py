"""Late-fusion three-stream GSTCAN in PyTorch (``models/fusion.py:81-110``).

Points STGCAN + motion STGCAN + sensor encoder -> concat (512 + num_classes)
-> ``fcn``. Names follow the notebook reference (``pts_stream``,
``mot_stream``, ``sensor``, ``fcn``); the notebook's trailing softmax is not
part of the forward, logits stay logits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.models.sensors import build_sensor_encoder
from fall_multimodal_tpu_torch.models.stgcan import (
    STGCAN_STAGES,
    STGCANBackbone,
    motion_stream,
)


class ThreeStreamGSTCAN(nn.Module):
    """``forward(skeleton (N,T,V,C), sensor (N,T,S)) -> (N, num_classes)``."""

    def __init__(self, num_classes: int, in_channels: int = 3, sensor_dim: int = 4,
                 graph_layout: str = "coco_cut", graph_strategy: str = "spatial",
                 sensor_encoder: str = "bilstm", dropout: float = 0.0,
                 stages: Sequence[Tuple[int, int, bool]] = STGCAN_STAGES,
                 dense_gcn: bool = True):
        super().__init__()
        self.sensor_encoder = sensor_encoder
        kw = dict(graph_layout=graph_layout, graph_strategy=graph_strategy,
                  stages=stages, dropout=dropout, dense_gcn=dense_gcn)
        self.pts_stream = STGCANBackbone(in_channels, **kw)
        self.mot_stream = STGCANBackbone(2, **kw)
        self.sensor = build_sensor_encoder(sensor_encoder, sensor_dim, num_classes)
        features = 2 * self.pts_stream.stages[-1][0] + num_classes
        self.fcn = nn.Linear(features, num_classes)

    def forward(self, skeleton: torch.Tensor, sensor: torch.Tensor) -> torch.Tensor:
        pts = self.pts_stream(skeleton)
        mot = self.mot_stream(motion_stream(skeleton))
        sen = self.sensor(sensor)
        return self.fcn(torch.cat([pts, mot, sen], dim=-1))
