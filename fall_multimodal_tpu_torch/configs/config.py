"""Typed config tree with YAML loading and dotted CLI overrides.

Replaces the reference's yacs schema (``Fall_2_Spatial_Temporal_SR/config.py``)
and the Gen-3 hard-coded constants (``Multimodal_Fall3/main.py:274-320``)
with one frozen dataclass tree. Field names are lowercase but map 1:1 onto the
yacs keys so the shipped presets translate directly; ``num_classes`` is
derived from data when a dataset provides labels, never mutated in place
(the reference defrost/freeze dance, ``dataloader.py:19-32``).

This is the PyTorch port's own copy of ``fall_multimodal_tpu/configs/
config.py``, schema unchanged, so that every preset and every training
run's ``config.json`` parses the same in both packages.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import yaml


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    label_smoothing: float = 0.0
    max_norm: float = 100.0          # gradient clipping (global norm)
    accum_iter: int = 1              # microbatch gradient accumulation
    batch_size: int = 32
    eval_batch_size: Optional[int] = None
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    drop_last: bool = True           # static shapes: drop ragged final batch
    # epoch execution (train/loop.py:resolve_epoch_impl): auto = scan on the
    # card, host on the cpu; with scan, fit() fuses the epochs by default
    epoch_impl: str = "auto"         # auto | scan | host
    # fused epochs: True = the whole run, an int = chunks of that many epochs
    # (rounded to a divisor of the epochs, loop.equal_chunk), one host read
    # each; None = fit()'s auto behaviour
    scan_epochs: Optional[int] = None


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "harup"           # harup | urfall | imvia | fukinect | synthetic
    path: Optional[str] = None       # dataset root (CSV dir or pickle list)
    in_channels: int = 3
    num_classes: int = 11
    sensor_dim: int = 15
    seq_len: int = 30
    num_joints: int = 14
    split: Tuple[float, float, float] = (0.6, 0.2, 0.2)
    split_by_video: bool = True      # video-level split (no window leakage)
    n_folds: int = 10
    # sample-level stratified CV folds (notebook KFold_load_dataset,
    # GSTCAN_HAR_conv_10kfold.ipynb:5); overrides split_by_video for CV.
    stratify_folds: bool = False


@dataclass(frozen=True)
class GraphConfig:
    layout: str = "coco_cut"
    strategy: str = "spatial"
    max_hop: int = 1
    dilation: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str = "stgcan"
    # Free-form model-family kwargs (embed_dim, n_stage, act_type, ...).
    kwargs: Dict[str, Any] = field(default_factory=dict)
    # Notebook-canonical GSTCAN applies F.softmax before CE (SURVEY.md 3.4);
    # reproduce-or-not is a config switch for accuracy parity.
    softmax_output: bool = False
    # Retained for config compatibility: the packaged Gen-2 st_gcan and the
    # notebook st_gcn express the same math (CA on the TCN output, then the
    # residual add — Model/stgcan.py:138-144 vs GSTCAN_UR_conv.ipynb:1), so
    # there is exactly one block semantics and this flag is a no-op.
    ca_before_residual: bool = True
    # From-scratch init scheme: "torch" (reference trains from torch module
    # defaults — its init_param helper is dead code), "init_param"
    # (musa_model.py:408-420 kaiming variants), or "flax" (lecun_normal).
    weight_init: str = "torch"


@dataclass(frozen=True)
class OptimConfig:
    type: str = "rmsprop"
    lr: float = 1e-3
    momentum: float = 0.0
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1.0e-8
    rms_decay: float = 0.99          # torch RMSprop alpha


@dataclass(frozen=True)
class SchedulerConfig:
    type: Optional[str] = None       # None | cosine | step | multistep
    t_initial: int = 500
    lr_min: float = 1.0e-5
    warmup_t: int = 5
    warmup_lr_init: float = 1.0e-4
    decay_rate: float = 0.1
    decay_steps: Tuple[int, ...] = ()


@dataclass(frozen=True)
class AugmentConfig:
    """On-device training-time augmentation (new capability; the reference
    trains on raw windows only). All transforms are drawn per window per
    step inside the jitted train step — zero host work, fused by XLA into
    the batch gather. Defaults are all-off; ``enabled`` additionally gates
    the whole block so a preset can carry tuned magnitudes while runs
    toggle one switch."""

    enabled: bool = False
    rotate_deg: float = 0.0      # uniform [-d, +d] degrees about the window centroid (x, y)
    scale: float = 0.0           # uniform gain [1-s, 1+s] about the centroid
    translate: float = 0.0       # uniform (x, y) shift in normalized units
    joint_jitter: float = 0.0    # gaussian sigma added per joint per frame (x, y)
    flip_prob: float = 0.0       # horizontal mirror + left/right joint swap
    sensor_noise: float = 0.0    # gaussian sigma on sensor channels
    sensor_scale: float = 0.0    # uniform per-window gain [1-s, 1+s]


@dataclass(frozen=True)
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    lr_scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 42
    log_dir: Optional[str] = None
    save_checkpoint: bool = True
    resume_from: Optional[str] = None
    pretrained_weight_path: Optional[str] = None
    test_only: bool = False
    top_k: Tuple[int, ...] = (1,)
    logging_interval: int = 10

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _parse_untyped(value: Any) -> Any:
    """``model.kwargs`` values have no dataclass type to coerce onto;
    recover numerics that YAML leaves as strings (PyYAML parses the
    dotless-exponent form ``'1e-3'`` as a string, so a ``--set
    model.kwargs.keep_prob=1e-3`` would otherwise reach the model as a
    str and fail at trace time)."""
    if isinstance(value, str):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
    return value


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce YAML scalars onto dataclass field types (tuples, optionals)."""
    origin = getattr(typ, "__origin__", None)
    if value is None or value == "None":
        return None
    if origin is tuple and isinstance(value, (list, tuple)):
        args = typ.__args__
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(args[0](v) for v in value)
        return tuple(a(v) for a, v in zip(args, value))
    if typ in (int, float, str, bool):
        return typ(value)
    return value


def _build(cls, data: Mapping[str, Any]):
    import typing

    hints = typing.get_type_hints(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in data.items():
        k = key.lower()
        if k not in fields:
            raise KeyError(
                f"Unknown config key {key!r} for {cls.__name__}; "
                f"valid keys: {sorted(fields)}"
            )
        if k in _SECTION_TYPES:
            kwargs[k] = _build(_SECTION_TYPES[k], value)
        elif k == "kwargs":
            kwargs[k] = {kk: _parse_untyped(vv) for kk, vv in dict(value).items()}
        else:
            typ = hints[k]
            if getattr(typ, "__origin__", None) is Union:  # Optional[...]
                inner = [a for a in typ.__args__ if a is not type(None)]
                typ = inner[0] if len(inner) == 1 else typ
            kwargs[k] = _coerce(value, typ)
    return cls(**kwargs)


_SECTION_TYPES = {
    "train": TrainConfig,
    "data": DataConfig,
    "model": ModelConfig,
    "graph": GraphConfig,
    "optim": OptimConfig,
    "lr_scheduler": SchedulerConfig,
    "augment": AugmentConfig,
}


def _apply_override(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.lower().split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Mapping[str, Any]] = None,
) -> Config:
    """Load a YAML preset and apply dotted overrides.

    ``overrides`` maps dotted keys (``"optim.lr"``, ``"data.num_classes"``)
    to values; strings are parsed with YAML so ``"1e-3"`` becomes a float.
    """
    tree: Dict[str, Any] = {}
    if path is not None:
        with open(path) as fh:
            loaded = yaml.safe_load(fh) or {}
        tree = {k.lower(): v for k, v in loaded.items()}
        for section in list(tree):
            if isinstance(tree[section], dict):
                tree[section] = {k.lower(): v for k, v in tree[section].items()}
    for dotted, value in (overrides or {}).items():
        if isinstance(value, str):
            value = yaml.safe_load(value)
        _apply_override(tree, dotted, value)
    return _build(Config, tree)


def preset_path(name: str) -> str:
    """Path of a shipped preset, e.g. ``preset_path("two_stgcan_bilstm_harup")``."""
    here = os.path.join(os.path.dirname(__file__), "presets", f"{name}.yaml")
    if not os.path.exists(here):
        available = sorted(
            f[:-5]
            for f in os.listdir(os.path.join(os.path.dirname(__file__), "presets"))
            if f.endswith(".yaml")
        )
        raise FileNotFoundError(f"No preset {name!r}; available: {available}")
    return here
