"""Checkpoints for the port: reference files and the JAX package's variables.

The port's modules carry the reference torch state_dict names, so a
reference checkpoint (notebook ``GSTCAN_UR_conv.ipynb:6`` state_dict, or
a ``best_model.pt``/``checkpoint.pt`` wrapping one) loads as it is:

    sd = load_state_dict_file("best_model.pt")
    load_into(build_model(config), sd)

The packaged Gen-2 code spells some names differently
(``st_gcan_networks``, ``stgcan_1``/``stgcan_2``, ``lstm``, ``fc``, and a
standalone STGCAN whose head is an ``fcn`` Linear); a file read by
:func:`load_state_dict_file` is brought to the notebook spelling by
:func:`normalize_reference_keys`.

:func:`state_dict_from_jax_variables` carries the JAX package's flax
``{"params", "batch_stats"}`` tree (as numpy arrays) into the same
state_dict: it is the inverse of the JAX package's reference converters
(``interop.py:_convert_stgcan`` ... ``_convert_cnn_bilstm``), so weights
trained there serve here. Every path fails loudly on missing, unused or
mis-shaped keys.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.graphs import build_adjacency

__all__ = [
    "DEAD_REFERENCE_KEYS",
    "load_into",
    "load_state_dict_file",
    "normalize_reference_keys",
    "state_dict_from_jax_variables",
]

# The reference CNN1D defines a flatten+Linear head (32x224) that its
# forward never calls (``GSTCAN_UR_conv.ipynb:2``); every notebook checkpoint
# carries it. The port does not build that module and drops exactly these
# keys when it reads a checkpoint file.
DEAD_REFERENCE_KEYS = ("sensor.cnn.fc.weight", "sensor.cnn.fc.bias")
# The repository's parity fixtures (``tests/fixtures/reference_*.npz``) store
# the reference's inputs and output beside its weights under these names.
FIXTURE_ARRAYS = ("x", "sensor", "out")


def _format_keys(keys, limit: int = 8) -> str:
    keys = sorted(".".join(k) if isinstance(k, tuple) else k for k in keys)
    more = f" (+{len(keys) - limit} more)" if len(keys) > limit else ""
    return ", ".join(keys[:limit]) + more


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


# ----------------------------------------------------- reference files

# Gen-2 attribute names (``Model/combination.py:13-16,33-35``) -> notebook names.
_GEN2_PREFIXES = (("stgcan_1.", "pts_stream."), ("stgcan_2.", "mot_stream."),
                  ("lstm.", "sensor."))
_GEN2_FUSION_HEAD = {"fc.weight": "fcn.weight", "fc.bias": "fcn.bias"}


def normalize_reference_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Bring the Gen-2 spellings of a reference state_dict to the notebook
    spellings the port's modules carry:

    * ``st_gcan_networks`` -> ``st_gcn_networks`` (any stream);
    * ``stgcan_1.`` / ``stgcan_2.`` -> ``pts_stream.`` / ``mot_stream.``;
    * ``lstm.`` (the fusion models' sensor stream) -> ``sensor.``;
    * the fusion head ``fc.{weight,bias}`` -> ``fcn.{weight,bias}``;
    * a standalone STGCAN (``data_bn`` at the root) whose head is an ``fcn``
      Linear ``(O, I)`` -> the ``cls`` 1x1 conv ``(O, I, 1, 1)``.

    Keys already in the notebook spelling pass through; a key that both
    spellings would claim raises. Nothing else is renamed or dropped, so an
    unknown key still fails in :func:`load_into`.
    """
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        new = _GEN2_FUSION_HEAD.get(key, key)
        for old, repl in _GEN2_PREFIXES:
            if new.startswith(old):
                new = repl + new[len(old):]
        new = new.replace("st_gcan_networks.", "st_gcn_networks.")
        if new in out:
            raise ValueError(f"state_dict holds {key!r} under two spellings ({new!r})")
        out[new] = value
    if "data_bn.weight" in out and "cls.weight" not in out and "fcn.weight" in out:
        weight = _to_numpy(out.pop("fcn.weight"))
        out["cls.weight"] = weight[:, :, None, None] if weight.ndim == 2 else weight
        out["cls.bias"] = out.pop("fcn.bias")
    return out


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """Read a reference checkpoint into ``{name: np.ndarray}``.

    Takes an ``.npz`` of named arrays, or a ``.pt``/``.pth`` holding a raw
    state_dict or one wrapped under ``model``/``state_dict``/
    ``model_state_dict`` (``main.py:323-341``). Drops
    :data:`DEAD_REFERENCE_KEYS`, and an ``.npz``'s :data:`FIXTURE_ARRAYS`;
    Gen-2 spellings are normalised (:func:`normalize_reference_keys`).
    """
    if path.endswith(".npz"):
        with np.load(path) as blob:
            sd = {k: np.asarray(blob[k]) for k in blob.files if k not in FIXTURE_ARRAYS}
    elif path.endswith((".pt", ".pth")):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(blob, dict):
            raise ValueError(f"{path!r} holds a {type(blob).__name__}, not a state_dict")
        for key in ("model", "state_dict", "model_state_dict"):
            inner = blob.get(key)
            if isinstance(inner, dict) and inner and all(
                    hasattr(v, "detach") for v in inner.values()):
                blob = inner
                break
        sd = {k: _to_numpy(v) for k, v in blob.items()}
    else:
        raise ValueError(f"checkpoint {path!r} is not .npz, .pt or .pth")
    sd = normalize_reference_keys(sd)
    for key in DEAD_REFERENCE_KEYS:
        sd.pop(key, None)
    return sd


def load_into(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> torch.nn.Module:
    """``model.load_state_dict(strict=True)`` after checking names and
    shapes, with every missing, unused and mis-shaped key spelled out."""
    want = model.state_dict()
    missing = set(want) - set(state_dict)
    unused = set(state_dict) - set(want)
    shaped = [f"{k} (model {tuple(want[k].shape)}, checkpoint "
              f"{tuple(np.shape(state_dict[k]))})"
              for k in sorted(set(want) & set(state_dict))
              if tuple(want[k].shape) != tuple(np.shape(state_dict[k]))]
    if missing or unused or shaped:
        raise ValueError(
            "state_dict does not fit the model:"
            + (f" missing {_format_keys(missing)};" if missing else "")
            + (f" unused {_format_keys(unused)};" if unused else "")
            + (f" mis-shaped {', '.join(shaped)};" if shaped else "")
            + " (wrong model family or model.kwargs for this checkpoint?)")
    tensors = {k: torch.tensor(_to_numpy(v), dtype=want[k].dtype)
               for k, v in state_dict.items()}
    model.load_state_dict(tensors, strict=True)
    return model


# ------------------------------------------------ JAX variables -> torch

class _FlaxReader:
    """Flattened flax collection with read tracking, so that leaves the
    conversion never consumed are reported."""

    def __init__(self, tree: Mapping[str, Any]):
        self.flat: Dict[Tuple[str, ...], np.ndarray] = {}
        self._walk((), tree)
        self.used = set()

    def _walk(self, prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                self._walk(prefix + (k,), v)
        else:
            self.flat[prefix] = np.asarray(node)

    def __call__(self, *path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"flax variables are missing {'.'.join(path)!r}")
        self.used.add(path)
        return self.flat[path]

    def unused(self):
        return set(self.flat) - self.used


def _dense_inv(kernel: np.ndarray) -> np.ndarray:
    """flax Dense (I, O) -> torch Linear (O, I)."""
    return np.ascontiguousarray(kernel.T)


def _conv1x1_inv(kernel: np.ndarray) -> np.ndarray:
    """flax Dense (I, O) -> torch 1x1 Conv2d (O, I, 1, 1)."""
    return np.ascontiguousarray(kernel.T[:, :, None, None])


def _conv_t_inv(kernel: np.ndarray) -> np.ndarray:
    """flax Conv (kT, 1, I, O) -> torch temporal Conv2d (O, I, kT, 1)."""
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def _conv1d_inv(kernel: np.ndarray) -> np.ndarray:
    """flax Conv (k, I, O) -> torch Conv1d (O, I, k)."""
    return np.ascontiguousarray(np.transpose(kernel, (2, 1, 0)))


def _join(prefix: str, name: str) -> str:
    """``prefix.name``, or ``name`` at the root (empty prefix)."""
    return f"{prefix}.{name}" if prefix else name


class _Writer:
    def __init__(self, params: _FlaxReader, stats: _FlaxReader):
        self.p, self.s = params, stats
        self.sd: Dict[str, np.ndarray] = {}

    def bn(self, theirs: str, *ours: str) -> None:
        """Our ``BatchNorm`` wrapper (inner ``BatchNorm_0``) -> torch BN."""
        inner = ours + ("BatchNorm_0",)
        self.sd[f"{theirs}.weight"] = self.p(*inner, "scale")
        self.sd[f"{theirs}.bias"] = self.p(*inner, "bias")
        self.sd[f"{theirs}.running_mean"] = self.s(*inner, "mean")
        self.sd[f"{theirs}.running_var"] = self.s(*inner, "var")
        # flax keeps no step count; momentum 0.1 never reads it
        self.sd[f"{theirs}.num_batches_tracked"] = np.array(0, np.int64)

    def dense(self, theirs: str, *ours: str, inv=_dense_inv) -> None:
        self.sd[f"{theirs}.weight"] = inv(self.p(*ours, "kernel"))
        self.sd[f"{theirs}.bias"] = self.p(*ours, "bias")

    def backbone(self, theirs: str, ours: str, stages, in_channels: int, A) -> None:
        self.sd[_join(theirs, "A")] = A
        self.bn(_join(theirs, "data_bn"), ours, "data_bn")
        cin = in_channels
        for i, (cout, stride, residual) in enumerate(stages):
            self.block(_join(theirs, f"st_gcn_networks.{i}"), ours, f"block{i}",
                       proj=residual and (cin != cout or stride != 1))
            self.sd[_join(theirs, f"edge_importance.{i}")] = self.p(
                ours, f"edge_importance_{i}")
            cin = cout

    def block(self, tb: str, *blk: str, proj: bool) -> None:
        """One flax ``STGCANBlock`` -> torch ``st_gcn_networks.{i}``."""
        self.dense(f"{tb}.gcn.conv", *blk, "GraphConv_0", "Dense_0", inv=_conv1x1_inv)
        self.bn(f"{tb}.tcn.0", *blk, "tcn_bn1")
        self.dense(f"{tb}.tcn.2", *blk, "TemporalConv_0", "Conv_0", inv=_conv_t_inv)
        self.bn(f"{tb}.tcn.3", *blk, "tcn_bn2")
        ca, se = f"{tb}.channel_attention_module.atten", blk + ("SqueezeExcite_0",)
        self.dense(f"{ca}.1", *se, "Dense_0", inv=_conv1x1_inv)
        self.bn(f"{ca}.2", *se, "BatchNorm_0")
        self.dense(f"{ca}.4", *se, "Dense_1", inv=_conv1x1_inv)
        if proj:
            self.dense(f"{tb}.residual.0", *blk, "res_proj", inv=_conv1x1_inv)
            self.bn(f"{tb}.residual.1", *blk, "res_bn")

    def bilstm_head(self, theirs: str, *ours: str) -> None:
        for direction, tag in (("fwd", ""), ("bwd", "_reverse")):
            cell = ours + ("BiLSTMLayer_0", direction)
            for gate in ("ih", "hh"):
                self.sd[_join(theirs, f"lstm1.weight_{gate}_l0{tag}")] = _dense_inv(
                    self.p(*cell, gate, "kernel"))
                self.sd[_join(theirs, f"lstm1.bias_{gate}_l0{tag}")] = self.p(
                    *cell, gate, "bias")
        self.bn(_join(theirs, "batchnorm"), *ours, "BatchNorm_0")
        att = ours + ("MlpChannelAttention_0",)
        self.dense(_join(theirs, "channelattention.attention.0"), *att, "Dense_0")
        self.dense(_join(theirs, "channelattention.attention.2"), *att, "Dense_1")
        self.dense(_join(theirs, "fc.1"), *ours, "Dense_0")

    def cnn_bilstm_head(self, theirs: str, *ours: str) -> None:
        cnn = ours + ("Cnn1d_0",)
        for j, layer in enumerate(("layer1", "layer2")):
            self.dense(_join(theirs, f"cnn.{layer}.0"), *cnn, f"Conv_{j}", inv=_conv1d_inv)
            self.bn(_join(theirs, f"cnn.{layer}.1"), *cnn, f"BatchNorm_{j}")
        self.bilstm_head(_join(theirs, "bilstm"), *ours, "BiLSTMHead_0")


def state_dict_from_jax_variables(config: Config,
                                  variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's state_dict for ``config``'s model from the JAX package's
    flax variables ``{"params": ..., "batch_stats": ...}`` (numpy leaves).

    Raises if a flax leaf is left unused or the result does not fit the
    port's model key for key and shape for shape.
    """
    from fall_multimodal_tpu_torch.models import (
        STGCANClassifier,
        ThreeStreamGSTCAN,
        TwoStreamSTGCAN,
        build_model,
    )
    from fall_multimodal_tpu_torch.models.sensors import SensorOnlyBiLSTM, SensorOnlyCnnBiLSTM

    model = build_model(config)
    w = _Writer(_FlaxReader(variables["params"]),
                _FlaxReader(variables.get("batch_stats", {})))
    cin = config.data.in_channels
    if isinstance(model, STGCANClassifier):
        A = build_adjacency(config.graph.layout, config.graph.strategy).astype(np.float32)
        w.backbone("", "STGCANBackbone_0", model.stages, cin, A)
        w.dense("cls", "STGCANBackbone_0", "cls", inv=_conv1x1_inv)
    elif isinstance(model, (TwoStreamSTGCAN, ThreeStreamGSTCAN)):
        A = build_adjacency(config.graph.layout, config.graph.strategy).astype(np.float32)
        stages = model.pts_stream.stages
        w.backbone("pts_stream", "pts_stream", stages, cin, A)
        w.backbone("mot_stream", "mot_stream", stages, 2, A)
        if isinstance(model, ThreeStreamGSTCAN):
            if model.sensor_encoder in ("cnn_bilstm", "cnn"):
                w.cnn_bilstm_head("sensor", "CnnBiLSTMHead_0")
            else:
                w.bilstm_head("sensor", "BiLSTMHead_0")
        w.dense("fcn", "Dense_0")
    elif isinstance(model, SensorOnlyCnnBiLSTM):
        w.cnn_bilstm_head("", "head")
    elif isinstance(model, SensorOnlyBiLSTM):
        w.bilstm_head("", "head")
    else:
        raise ValueError(f"no JAX-variables conversion for model {config.model.name!r}")
    unused = w.p.unused() | w.s.unused()
    if unused:
        raise ValueError(f"flax variables not consumed: {_format_keys(unused)}")
    load_into(model, w.sd)   # validates names and shapes against the port's model
    return {k: w.sd[k] for k in model.state_dict()}
