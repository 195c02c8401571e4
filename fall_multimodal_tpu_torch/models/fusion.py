"""Late-fusion heads in PyTorch: 1-, 2- and 3-stream models
(``models/fusion.py:34-110``).

* :class:`STGCANClassifier` — single-stream skeleton classifier: the
  backbone with its ``cls`` head, the reference's standalone ``STGCAN``
  (state_dict keys at the root: ``data_bn.*``, ``st_gcn_networks.*``,
  ``cls.*``);
* :class:`TwoStreamSTGCAN` — points + motion, concat 512 -> ``fcn``;
* :class:`ThreeStreamGSTCAN` — points + motion + sensor encoder, concat
  (512 + num_classes) -> ``fcn``;
* :class:`TransformerEnsemble` — the skeleton transformer's logits and a
  CNN_BiLSTM's on the sensor, concat -> ``fc.0`` (``fusion.py:113-146``).

Names follow the notebook reference (``pts_stream``, ``mot_stream``,
``sensor``, ``fcn``); the notebook's trailing softmax is not part of the
forward, logits stay logits. Every model shares the forward contract
``module(skeleton (N,T,V,C), sensor (N,T,S) | None, generator=None) ->
(N, num_classes)``; ``generator`` (the train state's) feeds every draw a
train-mode forward makes, and an eval forward takes none.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.models.sensors import CnnBiLSTMHead, build_sensor_encoder
from fall_multimodal_tpu_torch.models.skeleton_transformer import SkeletonTransformer
from fall_multimodal_tpu_torch.models.stgcan import (
    STGCAN_STAGES,
    STGCANBackbone,
    motion_stream,
)


class STGCANClassifier(STGCANBackbone):
    """The backbone with its ``cls`` head on the ``(skeleton, sensor)``
    contract; the sensor stream is ignored."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 graph_layout: str = "coco_cut", graph_strategy: str = "spatial",
                 dropout: float = 0.0,
                 stages: Sequence[Tuple[int, int, bool]] = STGCAN_STAGES,
                 dense_gcn: bool = True):
        super().__init__(in_channels, graph_layout=graph_layout,
                         graph_strategy=graph_strategy, num_classes=num_classes,
                         stages=stages, dropout=dropout, dense_gcn=dense_gcn)

    def forward(self, skeleton: torch.Tensor, sensor: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(skeleton, generator)


class TwoStreamSTGCAN(nn.Module):
    """Points STGCAN + motion STGCAN -> concat -> ``fcn``; the sensor stream
    is ignored."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 graph_layout: str = "coco_cut", graph_strategy: str = "spatial",
                 dropout: float = 0.0,
                 stages: Sequence[Tuple[int, int, bool]] = STGCAN_STAGES,
                 dense_gcn: bool = True):
        super().__init__()
        kw = dict(graph_layout=graph_layout, graph_strategy=graph_strategy,
                  stages=stages, dropout=dropout, dense_gcn=dense_gcn)
        self.pts_stream = STGCANBackbone(in_channels, **kw)
        self.mot_stream = STGCANBackbone(2, **kw)
        self.fcn = nn.Linear(2 * self.pts_stream.stages[-1][0], num_classes)

    def forward(self, skeleton: torch.Tensor, sensor: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pts = self.pts_stream(skeleton, generator)
        mot = self.mot_stream(motion_stream(skeleton), generator)
        return self.fcn(torch.cat([pts, mot], dim=-1))


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

    def forward(self, skeleton: torch.Tensor, sensor: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pts = self.pts_stream(skeleton, generator)
        mot = self.mot_stream(motion_stream(skeleton), generator)
        sen = self.sensor(sensor)
        return self.fcn(torch.cat([pts, mot, sen], dim=-1))


class TransformerEnsemble(nn.Module):
    """``skeleton_transformer`` (points) + ``signal_model`` (CNN_BiLSTM on the
    sensor), their logits concatenated -> ``fc.0`` (notebook
    ``GSTCAN_HAR_conv_kfold_trans.ipynb:3`` ``Ensemble``). The reference's
    ``signal_model.cnn.fc`` is never called and not built
    (``interop.DEAD_REFERENCE_KEYS``)."""

    def __init__(self, num_classes: int, in_channels: int = 3, sensor_dim: int = 15,
                 n_joints: int = 14, seq_len: int = 30, embedding_dim: int = 32,
                 n_block: int = 6, head_dim: int = 16, n_heads: int = 8):
        super().__init__()
        self.skeleton_transformer = SkeletonTransformer(
            num_classes, in_channels=in_channels, n_joints=n_joints, seq_len=seq_len,
            embedding_dim=embedding_dim, n_block=n_block, head_dim=head_dim, n_heads=n_heads)
        self.signal_model = CnnBiLSTMHead(sensor_dim, num_classes)
        self.fc = nn.Sequential(nn.Linear(2 * num_classes, num_classes))

    def forward(self, skeleton: torch.Tensor, sensor: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out1 = self.skeleton_transformer(skeleton, generator=generator)
        return self.fc(torch.cat([out1, self.signal_model(sensor)], dim=-1))
