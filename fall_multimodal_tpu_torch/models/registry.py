"""Model factory: config -> ``torch.nn.Module`` (``models/registry.py``).

Registered: the STGCAN families ``stgcan`` (alias ``stgcn``; single
stream), ``two_stgcan`` (points + motion), ``two_stgcan_bilstm`` and
``gstcan_3stream`` (points + motion + sensor; the latter is the flagship),
and the sensor-only ``bilstm`` and ``cnn_bilstm``. Every module shares the
forward contract ``module(skeleton, sensor) -> (N, K) logits``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch.nn as nn

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.models.fusion import (
    STGCANClassifier,
    ThreeStreamGSTCAN,
    TwoStreamSTGCAN,
)
from fall_multimodal_tpu_torch.models.sensors import SensorOnlyBiLSTM, SensorOnlyCnnBiLSTM

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
