"""Model factory: config -> ``torch.nn.Module`` (``models/registry.py``).

Registered: the STGCAN families ``stgcan`` (alias ``stgcn``; single
stream), ``two_stgcan`` (points + motion), ``two_stgcan_bilstm`` and
``gstcan_3stream`` (points + motion + sensor; the latter is the flagship),
the sensor-only ``bilstm`` and ``cnn_bilstm``, the Gen-3 ``musa`` and
``musa_ablation``, and the Gen-1 ``targcn``, ``skeleton_transformer``,
``skeleton_transformer_factorized`` and ``transformer_ensemble`` (skeleton
transformer + sensor). Every module shares the forward contract
``module(skeleton, sensor, generator=None) -> (N, K) logits``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch.nn as nn

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.models.fusion import (
    STGCANClassifier,
    ThreeStreamGSTCAN,
    TransformerEnsemble,
    TwoStreamSTGCAN,
)
from fall_multimodal_tpu_torch.models.musa import MusaModel
from fall_multimodal_tpu_torch.models.sensors import SensorOnlyBiLSTM, SensorOnlyCnnBiLSTM
from fall_multimodal_tpu_torch.models.skeleton_transformer import SkeletonTransformer
from fall_multimodal_tpu_torch.models.targcn import TARGCN

_REGISTRY: Dict[str, Callable[[Config, Dict[str, Any]], nn.Module]] = {}
# Families whose forward reads the sensor stream; serving refuses
# ``sensor=None`` for them instead of zero-filling.
_SENSOR_CONSUMERS = set()


def register(name: str, uses_sensor: bool = False):
    def deco(fn):
        _REGISTRY[name] = fn
        if uses_sensor:
            _SENSOR_CONSUMERS.add(name)
        return fn

    return deco


def model_names():
    return sorted(_REGISTRY)


def uses_sensor(name: str) -> bool:
    """True if the named model family consumes the sensor stream."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {model_names()}")
    return name in _SENSOR_CONSUMERS


def build_model(config: Config) -> nn.Module:
    name = config.model.name
    if name not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {model_names()}")
    return _REGISTRY[name](config, dict(config.model.kwargs))


def _skeleton_kwargs(cfg: Config, kw) -> Dict[str, Any]:
    return dict(num_classes=cfg.data.num_classes, in_channels=cfg.data.in_channels,
                graph_layout=cfg.graph.layout, graph_strategy=cfg.graph.strategy, **kw)


@register("stgcan")
@register("stgcn")  # reference alias
def _stgcan(cfg: Config, kw):
    return STGCANClassifier(**_skeleton_kwargs(cfg, kw))


@register("two_stgcan")
def _two_stgcan(cfg: Config, kw):
    return TwoStreamSTGCAN(**_skeleton_kwargs(cfg, kw))


def _three_stream(cfg: Config, kw) -> ThreeStreamGSTCAN:
    return ThreeStreamGSTCAN(sensor_dim=cfg.data.sensor_dim, **_skeleton_kwargs(cfg, kw))


@register("two_stgcan_bilstm", uses_sensor=True)
def _two_stgcan_bilstm(cfg: Config, kw):
    kw.setdefault("sensor_encoder", "bilstm")
    return _three_stream(cfg, kw)


@register("gstcan_3stream", uses_sensor=True)
def _gstcan_3stream(cfg: Config, kw):
    kw.setdefault("sensor_encoder", "cnn_bilstm")
    return _three_stream(cfg, kw)


@register("bilstm", uses_sensor=True)
def _bilstm(cfg: Config, kw):
    return SensorOnlyBiLSTM(cfg.data.sensor_dim, cfg.data.num_classes, **kw)


@register("cnn_bilstm", uses_sensor=True)
def _cnn_bilstm(cfg: Config, kw):
    return SensorOnlyCnnBiLSTM(cfg.data.sensor_dim, cfg.data.num_classes, **kw)


def _musa_kwargs(cfg: Config, kw) -> Dict[str, Any]:
    kw.pop("max_frame", None)   # a reference constructor argument the math never reads
    return dict(num_classes=cfg.data.num_classes, in_channels=cfg.data.in_channels,
                num_joints=cfg.data.num_joints, graph_layout=cfg.graph.layout,
                graph_strategy=cfg.graph.strategy, **kw)


@register("musa")
def _musa(cfg: Config, kw):
    return MusaModel(**_musa_kwargs(cfg, kw))


@register("musa_ablation")
def _musa_ablation(cfg: Config, kw):
    kw["with_tail"] = False
    return MusaModel(**_musa_kwargs(cfg, kw))


@register("targcn")
def _targcn(cfg: Config, kw):
    return TARGCN(num_classes=cfg.data.num_classes, num_nodes=cfg.data.num_joints,
                  in_channels=cfg.data.in_channels, seq_len=cfg.data.seq_len, **kw)


def _transformer_kwargs(cfg: Config, kw) -> Dict[str, Any]:
    return dict(num_classes=cfg.data.num_classes, in_channels=cfg.data.in_channels,
                n_joints=cfg.data.num_joints, seq_len=cfg.data.seq_len, **kw)


@register("skeleton_transformer")
def _skeleton_transformer(cfg: Config, kw):
    return SkeletonTransformer(**_transformer_kwargs(cfg, kw))


@register("skeleton_transformer_factorized")
def _skeleton_transformer_factorized(cfg: Config, kw):
    kw["factorized"] = True
    return SkeletonTransformer(**_transformer_kwargs(cfg, kw))


@register("transformer_ensemble", uses_sensor=True)
def _transformer_ensemble(cfg: Config, kw):
    return TransformerEnsemble(sensor_dim=cfg.data.sensor_dim, **_transformer_kwargs(cfg, kw))
