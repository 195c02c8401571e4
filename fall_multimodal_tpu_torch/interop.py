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
trained there serve here. :func:`optimizer_state_from_jax` carries the optax
state of a JAX train state into the port's optimizer, each per-parameter
leaf through its parameter's layout transform, so a JAX run resumes here.
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
    "normalize_reference_keys",
    "optimizer_state_from_jax",
    "state_dict_from_jax_variables",
]

# The reference CNN1D defines a flatten+Linear head (32x224) that its
# forward never calls (``GSTCAN_UR_conv.ipynb:2``); every notebook checkpoint
# carries it. The port does not build that module and drops exactly these
# keys when it reads a checkpoint file: the three-stream models' ``sensor``
# head, and the transformer ensemble's ``signal_model``.
DEAD_REFERENCE_KEYS = ("sensor.cnn.fc.weight", "sensor.cnn.fc.bias",
                       "signal_model.cnn.fc.weight", "signal_model.cnn.fc.bias")
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
    :data:`DEAD_REFERENCE_KEYS` and an
    ``.npz``'s :data:`FIXTURE_ARRAYS`;
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


def _end_conv_inv(kernel: np.ndarray, steps: int) -> np.ndarray:
    """flax Dense over (steps, H) ``(steps*H, O)`` -> torch ``Conv2d(steps, O,
    (1, H))`` weight ``(O, steps, 1, H)``."""
    o = kernel.shape[1]
    return np.ascontiguousarray(np.transpose(kernel.reshape(steps, -1, o), (2, 0, 1))[:, :, None])


class _Writer:
    def __init__(self, params: _FlaxReader, stats: _FlaxReader):
        self.p, self.s = params, stats
        self.sd: Dict[str, np.ndarray] = {}

    def bn(self, theirs: str, *ours: str) -> None:
        """Our ``BatchNorm`` wrapper (inner ``BatchNorm_0``) -> torch BN."""
        self.raw_bn(theirs, *ours, "BatchNorm_0")

    def raw_bn(self, theirs: str, *ours: str) -> None:
        """A bare flax ``nn.BatchNorm`` (no wrapper level) -> torch BN."""
        self.layer_norm(theirs, *ours)
        self.sd[f"{theirs}.running_mean"] = self.s(*ours, "mean")
        self.sd[f"{theirs}.running_var"] = self.s(*ours, "var")
        # flax keeps no step count; momentum 0.1 never reads it
        self.sd[f"{theirs}.num_batches_tracked"] = np.array(0, np.int64)

    def layer_norm(self, theirs: str, *ours: str) -> None:
        """A flax norm's affine (``scale``, ``bias``) -> torch's."""
        self.sd[f"{theirs}.weight"] = self.p(*ours, "scale")
        self.sd[f"{theirs}.bias"] = self.p(*ours, "bias")

    def dense(self, theirs: str, *ours: str, inv=_dense_inv, bias: bool = True) -> None:
        self.sd[f"{theirs}.weight"] = inv(self.p(*ours, "kernel"))
        if bias:
            self.sd[f"{theirs}.bias"] = self.p(*ours, "bias")

    def optional_bias_dense(self, theirs: str, *ours: str, inv=_dense_inv) -> None:
        self.dense(theirs, *ours, inv=inv, bias=(*ours, "bias") in self.p.flat)

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


    # ---- Gen-3 musa (JAX ``interop.py:_convert_musa``)

    def musa(self, model, A) -> None:
        n_stage = len(model.stream_pos) // 3
        with_tail = len(model.stream_pos) % 3 == 1
        idx = len(model.joint_embed_pos.cnn) - 1            # 1 behind embed_norm's BN
        if idx:
            self.bn("joint_embed_pos.cnn.0.bn", "norm_pos")
        for theirs, ours in (("joint_embed_pos", "joint_embed_pos"),
                             ("joint_embed_mos", "joint_embed_mot")):
            self.optional_bias_dense(f"{theirs}.cnn.{idx}.cnn", ours, inv=_conv1x1_inv)
        for stream in ("stream_pos", "stream_mot"):
            for s in range(n_stage):
                ours, t = (stream, f"sgc{s}"), f"{stream}.{3 * s}"
                self.sd[f"{t}.A"] = A
                if (*ours, "edge") in self.p.flat:
                    self.sd[f"{t}.edge"] = self.p(*ours, "edge")
                self.optional_bias_dense(f"{t}.gcn", *ours, "Dense_0", inv=_conv1x1_inv)
                self.bn(f"{t}.bn", *ours, "bn")
                if (*ours, "res_proj", "kernel") in self.p.flat:
                    self.optional_bias_dense(f"{t}.residual.0", *ours, "res_proj",
                                             inv=_conv1x1_inv)
                    self.bn(f"{t}.residual.1", *ours, "res_bn")
                for off, tag in ((1, "a"), (2, "b")):
                    ours, t = (stream, f"sep{s}{tag}"), f"{stream}.{3 * s + off}"
                    self.sd[f"{t}.A"] = A
                    if (*ours, "edge") in self.p.flat:
                        self.sd[f"{t}.edge"] = self.p(*ours, "edge")
                    self.optional_bias_dense(f"{t}.depth_conv.0", *ours, "depthwise",
                                             inv=_conv_t_inv)
                    self.bn(f"{t}.depth_conv.1", *ours, "depth_bn")
                    self.optional_bias_dense(f"{t}.point_conv.0", *ours, "pointwise",
                                             inv=_conv1x1_inv)
                    self.bn(f"{t}.point_conv.1", *ours, "point_bn")
                    if (*ours, "res_proj", "kernel") in self.p.flat:
                        self.optional_bias_dense(f"{t}.residual.0", *ours, "res_proj",
                                                 inv=_conv1x1_inv)
                        self.bn(f"{t}.residual.1", *ours, "res_bn")
            if with_tail:
                ours, t = (stream, "tail"), f"{stream}.{3 * n_stage}"
                for sep in ("sep31", "sep11"):
                    self.dense(f"{t}.{sep}.seq.0", *ours, sep, "depthwise", inv=_conv_t_inv)
                    self.bn(f"{t}.{sep}.seq.1", *ours, sep, "bn1")
                    self.dense(f"{t}.{sep}.seq.3", *ours, sep, "pointwise", inv=_conv1x1_inv)
                    self.bn(f"{t}.{sep}.seq.4", *ours, sep, "bn2")
                self.dense(f"{t}.shortcut", *ours, "shortcut", inv=_conv1x1_inv)
        self.dense("fc.seq.0", "fc", "Dense_0")
        self.layer_norm("fc.seq.2", "fc", "LayerNorm_0")
        self.dense("fc.seq.5", "fc", "Dense_1")

    # ---- Gen-1 TARGCN (JAX ``interop.py:_port_targcn``)

    def gru_gcn(self, theirs: str, *ours: str) -> None:
        """One graph conv of a graph-GRU cell, any ``gcn_variant``."""
        if (*ours, "weights_pool") in self.p.flat:            # gated | nogate
            self.sd[f"{theirs}.weights_pool"] = self.p(*ours, "weights_pool")
            self.sd[f"{theirs}.bias_pool"] = self.p(*ours, "bias_pool")
            if (*ours, "static_linear", "kernel") in self.p.flat:
                self.dense(f"{theirs}.linear", *ours, "static_linear")
        elif (*ours, "Dense_0", "kernel") in self.p.flat:      # linear
            self.dense(f"{theirs}.linear", *ours, "Dense_0")
        else:                                                  # sa
            self.dense(f"{theirs}.wq", *ours, "wq")
            self.dense(f"{theirs}.wk", *ours, "wk")
            self.dense(f"{theirs}.wv", *ours, "wv", bias=False)

    def ta_layer(self, theirs: str, *ours: str) -> None:
        """One TA layer (``TA.py:22-69``)."""
        self.dense(f"{theirs}.vff", *ours, "vff")
        self.dense(f"{theirs}.conv1", *ours, "conv_q", inv=_conv_t_inv)
        self.dense(f"{theirs}.conv2", *ours, "conv_k", inv=_conv_t_inv)
        self.layer_norm(f"{theirs}.ln", *ours, "ln")
        self.layer_norm(f"{theirs}.lnff", *ours, "lnff")
        self.dense(f"{theirs}.ff.0", *ours, "ff1")
        self.dense(f"{theirs}.ff.2", *ours, "ff2")

    def targcn(self, model) -> None:
        self.sd["node_embeddings"] = self.p("node_embeddings")
        for layer in range(len(model.encoder.dcrnn_cells)):
            for gate in ("gate", "update"):
                self.gru_gcn(f"encoder.dcrnn_cells.{layer}.{gate}",
                             "encoder", f"layer{layer}", "cell", gate)
        ta = model.encoder.trans_layer_T
        self.sd["encoder.trans_layer_T.PE.pe"] = ta.PE.pe.numpy()
        for i in range(len(ta.trans_layers)):
            self.ta_layer(f"encoder.trans_layer_T.trans_layers.{i}",
                          "encoder", "temporal_transformer", f"layer{i}")
        self.dense("end_conv", "end_conv",
                   inv=lambda k: _end_conv_inv(k, model.context_steps))
        self.dense("fc.2", "head")

    # ---- Gen-1 skeleton transformer (JAX ``interop.py:_port_skeleton_transformer``)

    def attention(self, theirs: str, *ours: str) -> None:
        self.dense(f"{theirs}.w_qkv", *ours, "w_qkv")
        self.dense(f"{theirs}.merge", *ours, "merge")
        self.sd[f"{theirs}.relative_position_bias_table"] = self.p(*ours, "rel_pos_bias")

    def b2t_st_block(self, theirs: str, *ours: str) -> None:
        """A ``B2TSpatialTemporalBlock`` (BatchNorm3d norms)."""
        self.attention(f"{theirs}.multi_head_spatial_self_attention", *ours, "spatial_attn")
        self.attention(f"{theirs}.multi_head_temporal_self_attention", *ours, "temporal_attn")
        for n in ("norm1", "norm2", "norm3"):
            self.raw_bn(f"{theirs}.{n}", *ours, n)
        self.ffn(f"{theirs}.feed_forward_network", *ours, "ffn")

    def ffn(self, theirs: str, *ours: str) -> None:
        self.dense(f"{theirs}.0", *ours, "Dense_0")
        self.dense(f"{theirs}.2", *ours, "Dense_1")

    def b2t_block(self, theirs: str, *ours: str) -> None:
        """A single-axis ``B2TBlock`` (``skeleton_transformer.py:291-320``)."""
        self.attention(f"{theirs}.multi_head_spatial_self_attention", *ours, "attn")
        self.layer_norm(f"{theirs}.norm1", *ours, "norm1")
        self.layer_norm(f"{theirs}.norm3", *ours, "norm3")
        self.ffn(f"{theirs}.feed_forward_network", *ours, "ffn")

    def skeleton_transformer(self, theirs: str, model, *ours: str) -> None:
        self.dense(_join(theirs, "embedding.0"), *ours, "embed1")
        self.dense(_join(theirs, "embedding.2"), *ours, "embed2")
        self.dense(_join(theirs, "fcn.0"), *ours, "head", inv=_conv1x1_inv)
        from fall_multimodal_tpu_torch.models.skeleton_transformer import TransposeAxis

        blocks = model.extractor
        transposes = [i for i, b in enumerate(blocks) if isinstance(b, TransposeAxis)]
        if transposes:                                         # Ablation1
            half = transposes[0]
            for i in range(half):
                self.b2t_block(_join(theirs, f"extractor.{i}"), *ours, f"spatial{i}")
                self.b2t_block(_join(theirs, f"extractor.{half + 1 + i}"), *ours,
                               f"temporal{i}")
        else:
            for i in range(len(blocks)):
                self.b2t_st_block(_join(theirs, f"extractor.{i}"), *ours, f"block{i}")


def _write_jax_variables(config: Config, variables: Mapping[str, Any]):
    """``(model, {torch name: array})``: ``config``'s model and every flax leaf
    of ``variables`` written under the port's names by :class:`_Writer`;
    raises if a flax leaf is left unused."""
    from fall_multimodal_tpu_torch.models import (
        TARGCN,
        MusaModel,
        SkeletonTransformer,
        STGCANClassifier,
        ThreeStreamGSTCAN,
        TransformerEnsemble,
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
    elif isinstance(model, MusaModel):
        w.musa(model, build_adjacency(config.graph.layout,
                                      config.graph.strategy).astype(np.float32))
    elif isinstance(model, TARGCN):
        w.targcn(model)
    elif isinstance(model, SkeletonTransformer):
        w.skeleton_transformer("", model)
    elif isinstance(model, TransformerEnsemble):
        w.skeleton_transformer("skeleton_transformer", model.skeleton_transformer,
                               "skeleton_transformer")
        w.cnn_bilstm_head("signal_model", "signal_model")
        w.dense("fc.0", "Dense_0")
    elif isinstance(model, SensorOnlyCnnBiLSTM):
        w.cnn_bilstm_head("", "head")
    elif isinstance(model, SensorOnlyBiLSTM):
        w.bilstm_head("", "head")
    else:
        raise ValueError(f"no JAX-variables conversion for model {config.model.name!r}")
    unused = w.p.unused() | w.s.unused()
    if unused:
        raise ValueError(f"flax variables not consumed: {_format_keys(unused)}")
    return model, w.sd


def state_dict_from_jax_variables(config: Config,
                                  variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's state_dict for ``config``'s model from the JAX package's
    flax variables ``{"params": ..., "batch_stats": ...}`` (numpy leaves).

    Raises if a flax leaf is left unused or the result does not fit the
    port's model key for key and shape for shape.
    """
    model, sd = _write_jax_variables(config, variables)
    load_into(model, sd)   # validates names and shapes against the port's model
    return {k: sd[k] for k in model.state_dict()}


# ------------------------------------------------ optax state -> torch

def _flat_leaves(tree, prefix=()):
    """``[(path, leaf)]`` of a nested mapping, in sorted key order."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out.extend(_flat_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, np.asarray(tree))]


def _parameter_gathers(config: Config, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]):
    """``(names, gathers)``: the port's trainable parameter names in the
    optimizer's order, and for each an index array into the concatenated
    flax parameter leaves, made by running :class:`_Writer` over leaves that
    hold their own element indices. Each gather must be a permutation of one
    whole leaf, and every leaf must feed exactly one parameter: then a
    params-shaped optax leaf is carried exactly as its parameter is."""
    leaves = _flat_leaves(params)
    offsets = np.cumsum([0] + [leaf.size for _, leaf in leaves])
    index_tree: Dict[str, Any] = {}
    for (path, leaf), off in zip(leaves, offsets):
        node = index_tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.arange(off, off + leaf.size, dtype=np.int64).reshape(leaf.shape)
    model, sd = _write_jax_variables(config, {"params": index_tree,
                                              "batch_stats": batch_stats})
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    gathers, fed = [], set()
    for name in names:
        idx = np.asarray(sd[name])
        j = int(np.searchsorted(offsets, idx.min(), side="right")) - 1 if idx.size else -1
        whole = (idx.dtype == np.int64 and j >= 0 and idx.size == leaves[j][1].size
                 and np.array_equal(np.sort(idx, axis=None),
                                    np.arange(offsets[j], offsets[j + 1])))
        if not whole or j in fed:
            raise ValueError(f"parameter {name!r} is not a permutation of one flax leaf; "
                             "its optimizer state cannot be carried")
        fed.add(j)
        gathers.append(idx)
    if len(fed) != len(leaves):
        missing = [".".join(leaves[j][0]) for j in range(len(leaves)) if j not in fed]
        raise ValueError(f"flax parameters without a trainable counterpart: {missing}")
    return names, gathers, [path for path, _ in leaves]


def _optax_parts(node, path=()) -> Dict[str, Any]:
    """Walk an optax state (NamedTuples, tuples, params-shaped mappings) and
    collect what the port's optimizer keeps: the moment trees by torch name,
    the update counts, the accumulation state. Only states the JAX package's
    ``build_optimizer`` makes are recognised; any other is refused, named
    by its path."""
    parts: Dict[str, Any] = {"moments": {}, "counts": [], "multi_steps": None}

    def walk(x, where):
        name = type(x).__name__
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            if not x._fields:                                  # EmptyState and kin
                return
            if name == "TorchRmsState":
                parts["moments"]["square_avg"] = x.square_avg
            elif name == "ScaleByAdamState":
                parts["counts"].append(int(np.asarray(x.count)))
                parts["moments"]["exp_avg"] = x.mu
                parts["moments"]["exp_avg_sq"] = x.nu
            elif name == "TraceState":
                parts["moments"]["momentum_buffer"] = x.trace
            elif name == "ScaleByScheduleState":
                parts["counts"].append(int(np.asarray(x.count)))
            elif name == "MultiStepsState" and not x.skip_state:
                parts["multi_steps"] = x
                walk(x.inner_opt_state, where + ("inner_opt_state",))
            else:
                raise ValueError(f"optax state {name} at {'/'.join(map(str, where)) or '.'} "
                                 "has no counterpart in the port's optimizer")
        elif isinstance(x, (tuple, list)):
            for i, y in enumerate(x):
                walk(y, where + (i,))
        else:
            raise ValueError(f"optax state leaf {'/'.join(map(str, where)) or '.'} "
                             f"({name}) is not a recognised optimizer state")

    walk(node, path)
    return parts


_MOMENTS = {"rmsprop": ("square_avg",), "rms": ("square_avg",),
            "adam": ("exp_avg", "exp_avg_sq"), "adamw": ("exp_avg", "exp_avg_sq")}


def optimizer_state_from_jax(config: Config, opt_state: Any, params: Mapping[str, Any],
                             batch_stats: Mapping[str, Any], step: int) -> Dict[str, Any]:
    """The port's :meth:`~fall_multimodal_tpu_torch.train.optim.Optimizer.
    state_dict` (CPU tensors) for ``config`` from a JAX train state's optax
    ``opt_state`` (its NamedTuples with numpy leaves), ``params`` and
    ``batch_stats`` (numpy leaves) and ``step`` (``TrainState.step``, the
    micro-steps taken). Nothing of JAX or optax is imported.

    The chain the JAX package's ``train/optim.py:120-174`` builds maps as:

    * ``TorchRmsState.square_avg`` -> RMSprop's ``square_avg``;
    * ``ScaleByAdamState(count, mu, nu)`` -> Adam's ``step``, ``exp_avg``,
      ``exp_avg_sq``;
    * ``TraceState.trace`` (SGD momentum) -> ``momentum_buffer``;
    * ``ScaleByScheduleState.count`` -> the updates taken (the port's
      ``gradient_step`` and torch's ``step``); without one (a constant lr,
      no Adam), ``step // accum_iter``;
    * ``MultiStepsState(mini_step, gradient_step, acc_grads)`` ->
      ``mini_step``, ``gradient_step`` and the accumulators ``acc``;
    * the clip and weight-decay stages keep no state.

    Each per-parameter leaf is carried through its parameter's layout
    transform (:func:`_parameter_gathers`), by name. Any other optax state,
    and a moment the config's optimizer does not keep, are refused.
    """
    from fall_multimodal_tpu_torch.models import build_model
    from fall_multimodal_tpu_torch.train.optim import build_optimizer

    names, gathers, paths = _parameter_gathers(config, params, batch_stats)
    parts = _optax_parts(opt_state)
    kind = config.optim.type
    want = _MOMENTS.get(kind, ("momentum_buffer",) if config.optim.momentum else ())
    if set(parts["moments"]) != set(want):
        raise ValueError(f"optax state holds {sorted(parts['moments'])}; the port's {kind!r} "
                         f"optimizer keeps {sorted(want)}")

    def carry(tree):
        flat_leaves = _flat_leaves(tree)
        if [p for p, _ in flat_leaves] != paths:
            raise ValueError("an optax moment tree does not have the parameters' structure")
        flat = np.concatenate([leaf.reshape(-1) for _, leaf in flat_leaves])
        return [torch.from_numpy(np.ascontiguousarray(flat[g])) for g in gathers]

    accum = max(1, int(config.train.accum_iter or 1))
    multi = parts["multi_steps"]
    counts = set(parts["counts"])
    if multi is not None:
        counts.add(int(np.asarray(multi.gradient_step)))
    if len(counts) > 1:
        raise ValueError(f"optax update counts disagree: {sorted(counts)}")
    updates = counts.pop() if counts else int(step) // accum
    if (multi is not None) != (accum > 1):
        raise ValueError(f"optax state {'has' if multi is not None else 'lacks'} MultiSteps "
                         f"but train.accum_iter is {accum}")

    optimizer = build_optimizer(config).init(build_model(config).parameters())
    moments = {key: carry(tree) for key, tree in parts["moments"].items()}
    for i, p in enumerate(optimizer.params):
        entry = {key: v[i] for key, v in moments.items()}
        if kind in _MOMENTS:
            entry["step"] = torch.tensor(float(updates))
        if entry:
            optimizer.inner.state[p] = entry
    optimizer.gradient_step = updates
    if multi is not None:
        optimizer.mini_step = int(np.asarray(multi.mini_step))
        for a, v in zip(optimizer.acc, carry(multi.acc_grads)):
            a.copy_(v)
    return optimizer.state_dict()
