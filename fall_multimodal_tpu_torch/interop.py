"""Checkpoints for the port: reference files and the JAX package's variables.

The port's modules carry the reference torch state_dict names, so a
reference checkpoint (notebook ``GSTCAN_UR_conv.ipynb:6`` state_dict, or
a ``best_model.pt``/``checkpoint.pt`` wrapping one) loads as it is:

    sd = load_state_dict_file("best_model.pt")
    load_into(build_model(config), sd)

:func:`state_dict_from_jax_variables` carries the JAX package's flax
``{"params", "batch_stats"}`` tree (as numpy arrays) into the same
state_dict: it is the inverse of the JAX package's reference converter
(``interop.py:_convert_three_stream``), so weights trained there serve here.
Every path fails loudly on missing, unused or mis-shaped keys.
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

def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """Read a reference checkpoint into ``{name: np.ndarray}``.

    Takes an ``.npz`` of named arrays, or a ``.pt``/``.pth`` holding a raw
    state_dict or one wrapped under ``model``/``state_dict``/
    ``model_state_dict`` (``main.py:323-341``). Drops
    :data:`DEAD_REFERENCE_KEYS`, and an ``.npz``'s :data:`FIXTURE_ARRAYS`.
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
        self.sd[f"{theirs}.A"] = A
        self.bn(f"{theirs}.data_bn", ours, "data_bn")
        cin = in_channels
        for i, (cout, stride, residual) in enumerate(stages):
            self.block(f"{theirs}.st_gcn_networks.{i}", ours, f"block{i}",
                       proj=residual and (cin != cout or stride != 1))
            self.sd[f"{theirs}.edge_importance.{i}"] = self.p(ours, f"edge_importance_{i}")
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
                self.sd[f"{theirs}.lstm1.weight_{gate}_l0{tag}"] = _dense_inv(
                    self.p(*cell, gate, "kernel"))
                self.sd[f"{theirs}.lstm1.bias_{gate}_l0{tag}"] = self.p(*cell, gate, "bias")
        self.bn(f"{theirs}.batchnorm", *ours, "BatchNorm_0")
        att = ours + ("MlpChannelAttention_0",)
        self.dense(f"{theirs}.channelattention.attention.0", *att, "Dense_0")
        self.dense(f"{theirs}.channelattention.attention.2", *att, "Dense_1")
        self.dense(f"{theirs}.fc.1", *ours, "Dense_0")

    def cnn_bilstm_head(self, theirs: str, *ours: str) -> None:
        cnn = ours + ("Cnn1d_0",)
        for j, layer in enumerate(("layer1", "layer2")):
            self.dense(f"{theirs}.cnn.{layer}.0", *cnn, f"Conv_{j}", inv=_conv1d_inv)
            self.bn(f"{theirs}.cnn.{layer}.1", *cnn, f"BatchNorm_{j}")
        self.bilstm_head(f"{theirs}.bilstm", *ours, "BiLSTMHead_0")


def state_dict_from_jax_variables(config: Config,
                                  variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's state_dict for ``config``'s model from the JAX package's
    flax variables ``{"params": ..., "batch_stats": ...}`` (numpy leaves).

    Raises if a flax leaf is left unused or the result does not fit the
    port's model key for key and shape for shape.
    """
    from fall_multimodal_tpu_torch.models import build_model

    model = build_model(config)
    w = _Writer(_FlaxReader(variables["params"]),
                _FlaxReader(variables.get("batch_stats", {})))
    A = build_adjacency(config.graph.layout, config.graph.strategy).astype(np.float32)
    stages = model.pts_stream.stages
    w.backbone("pts_stream", "pts_stream", stages, config.data.in_channels, A)
    w.backbone("mot_stream", "mot_stream", stages, 2, A)
    if model.sensor_encoder in ("cnn_bilstm", "cnn"):
        w.cnn_bilstm_head("sensor", "CnnBiLSTMHead_0")
    else:
        w.bilstm_head("sensor", "BiLSTMHead_0")
    w.dense("fcn", "Dense_0")
    unused = w.p.unused() | w.s.unused()
    if unused:
        raise ValueError(f"flax variables not consumed: {_format_keys(unused)}")
    load_into(model, w.sd)   # validates names and shapes against the port's model
    return {k: w.sd[k] for k in model.state_dict()}
