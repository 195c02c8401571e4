"""Serving layer of the port: checkpoint -> predictor -> streaming classifier.

Counterpart of ``fall_multimodal_tpu/serve.py``:

* :func:`with_kernels` — the one route from a model to the kernels: every
  submodule a kernel computes is swapped for that kernel's module by type
  (:data:`KERNEL_RULES`: a headed STGCAN backbone to K2 in one launch, a
  headless one to K1 a block, a ``TemporalTransformer`` the kernel takes to
  K3, a ``GraphGRUCell`` the kernel takes to K4 a layer); every other module
  stays a plain PyTorch module;
* :class:`Predictor` — loads weights into the model of any registered
  family and serves it through :func:`with_kernels`; pads ragged requests
  to ``batch_size`` and chunks larger ones; with ``num_copies`` > 1 it
  averages the logits of k time slices of each window
  (:func:`~fall_multimodal_tpu_torch.train.loop.k_copies_logits`), each
  slice through the same kernels;
* :func:`checkpoint_state_dict` — the weights of a checkpoint directory
  the port's trainer wrote (``best`` or ``latest``);
* :func:`export_pt2` / :func:`load_pt2` — the plain eval forward saved as a
  ``torch.export`` program (``.pt2``) at a fixed batch, and loaded back as a
  callable (the JAX package exports its plain ``model.apply`` the same way,
  not the kernel path);
* :class:`StreamingClassifier` — online sliding-window inference over a
  live pose/sensor stream;
* :func:`measure_push_latency` and the ``predict | latency | export | serve``
  CLI.

Everything runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card and no explicit CPU request it raises.

Served results are full float32 whatever the process-wide TF32 switches say
(PyTorch lets cuDNN convolutions and LSTMs use TF32 by default, about three
decimal digits): the kernels multiply in split TF32, which keeps float32
accuracy, and :meth:`Predictor.forward` runs the served module (its plain
modules: sensor head, fusion head, the sensor-only families) under
:func:`full_float32`, which switches TF32 off for the call and puts the
caller's settings back.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.interop import load_into, load_state_dict_file
from fall_multimodal_tpu_torch.models import TARGCN, STGCANBackbone, build_model, uses_sensor
from fall_multimodal_tpu_torch.models.targcn import GraphGRUCell, TemporalTransformer
from fall_multimodal_tpu_torch.ops import graph_gru, temporal_transformer
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import WholeBackbone
from fall_multimodal_tpu_torch.train.loop import k_copies_logits
from fall_multimodal_tpu_torch.utils.device import full_float32, resolve_device, synchronize
from fall_multimodal_tpu_torch.utils.profiling import span

# (module type, whether the kernel takes this module, the kernel's module
# built from it): the first rule that holds for a module replaces it.
KERNEL_RULES = (
    (STGCANBackbone, lambda m: m.cls is not None, WholeBackbone),          # K2
    (STGCANBackbone, lambda m: m.cls is None, FusedBackbone),              # K1 a block
    (TemporalTransformer, temporal_transformer.kernel_takes,
     temporal_transformer.FusedTemporalTransformer),                       # K3
    (GraphGRUCell, graph_gru.kernel_takes, graph_gru.FusedGraphGRU),       # K4 a layer
)


def with_kernels(model: nn.Module) -> nn.Module:
    """``model`` with every submodule a kernel computes, the root included,
    replaced by that kernel's module (:data:`KERNEL_RULES`; the kernels' packs
    are made here, once, on the device the weights are on). ``model`` is not
    changed: the result shares every module it does not replace and copies
    only the containers on the path to one it does, so the weights are held
    once."""
    for kind, takes, kernel in KERNEL_RULES:
        if isinstance(model, kind) and takes(model):
            return kernel(model).eval()
    swapped = {name: with_kernels(child) for name, child in model._modules.items()
               if child is not None}
    swapped = {name: m for name, m in swapped.items() if m is not model._modules[name]}
    if not swapped:
        return model
    out = copy.copy(model)
    out._modules = dict(model._modules)
    for name, module in swapped.items():
        setattr(out, name, module)
    return out


class Predictor:
    """Fixed-batch predictor around a trained model of any registered family.

    ``state_dict`` holds the model's weights under the reference names
    (arrays or tensors). Smaller requests are padded to ``batch_size`` by
    repeating the last window, larger ones chunked. Skeleton-only families
    take ``sensor=None``. ``num_copies`` > 1 serves the Gen-3 k-copies
    rule: the mean logits of ``num_copies`` contiguous time slices of each
    window (``Multimodal_Fall3/main.py:150-161``).

    ``model`` is the loaded model with its stock modules; ``served`` is
    :func:`with_kernels` of it, what :meth:`forward` runs.

    ``Predictor.calls`` counts :meth:`predict_logits` calls of every
    predictor; under a profiler each call is a ``predict_logits`` span with
    ``predict.prep``, ``predict.h2d``, ``predict.launch`` and
    ``predict.d2h`` spans per chunk (:func:`~fall_multimodal_tpu_torch.
    utils.profiling.span`).
    """

    calls = 0

    def __init__(self, config: Config, state_dict: Mapping[str, Any],
                 batch_size: int = 128, device="cuda", num_copies: int = 1):
        if not 1 <= num_copies <= config.data.seq_len:
            raise ValueError(f"num_copies={num_copies} must be between 1 and the window "
                             f"length {config.data.seq_len}")
        self.config = config
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.num_copies = num_copies
        self.requires_sensor = uses_sensor(config.model.name)
        self.model = load_into(build_model(config), state_dict).to(self.device).eval()
        if num_copies > 1 and isinstance(self.model, TARGCN):
            raise ValueError(f"num_copies={num_copies}: TARGCN takes only whole windows of "
                             f"T={config.data.seq_len} frames, so it serves num_copies=1")
        self.served = with_kernels(self.model)

    def with_batch_size(self, batch_size: int) -> "Predictor":
        """A predictor over the same model and served module at another
        batch size (e.g. batch 1 for streaming), with the same
        ``num_copies``."""
        if batch_size == self.batch_size:
            return self
        other = copy.copy(self)
        other.batch_size = batch_size
        return other

    @classmethod
    def from_checkpoint(cls, config: Config, checkpoint_dir: str, which: str = "best",
                        **kwargs) -> "Predictor":
        """Serve the model weights of a checkpoint directory the port's
        trainer wrote (``<out>/ckpt`` of a run, ``<out>/ckpt/fold{i}`` of a
        CV fold): ``which`` is ``"best"`` or ``"latest"``, read through
        :meth:`~fall_multimodal_tpu_torch.utils.checkpoint.Checkpointer.file`
        (its ``.prev`` copy after a crash inside a save). Only the weights
        are read; no optimizer or train state is built."""
        device = kwargs["device"] = resolve_device(kwargs.get("device", "cuda"))
        return cls(config, checkpoint_state_dict(checkpoint_dir, which, device), **kwargs)

    @classmethod
    def from_torch_checkpoint(cls, config: Config, path: str, strict: bool = True,
                              **kwargs) -> "Predictor":
        """Serve a reference checkpoint file (``.pt``/``.pth``/``.npz``).
        ``strict=False`` ignores the file's keys that the model does not
        have (as the JAX package's ``torch_to_variables``); a missing or
        mis-shaped key is an error either way."""
        state_dict = load_state_dict_file(path)
        if not strict:
            want = build_model(config).state_dict()
            state_dict = {k: v for k, v in state_dict.items() if k in want}
        return cls(config, state_dict, **kwargs)

    def forward(self, skeleton: torch.Tensor,
                sensor: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits of one batch already on the device, through the served
        module (:func:`with_kernels`), once per time slice under k-copies.
        The plain modules run in full float32 (:func:`full_float32`)."""
        if self.num_copies > 1:
            return k_copies_logits(self._forward, skeleton, sensor, self.num_copies)
        return self._forward(skeleton, sensor)

    def _forward(self, skeleton: torch.Tensor,
                 sensor: Optional[torch.Tensor] = None) -> torch.Tensor:
        with full_float32():
            return self.served(skeleton, sensor)

    @torch.inference_mode()
    def predict_logits(self, skeleton: np.ndarray,
                       sensor: Optional[np.ndarray] = None) -> np.ndarray:
        Predictor.calls += 1
        with span("predict_logits"):
            n = len(skeleton)
            if sensor is None:
                if self.requires_sensor:
                    raise ValueError(
                        f"model {self.config.model.name!r} consumes the sensor "
                        "stream; pass sensor=(N, T, S) windows (zero-filling "
                        "would silently classify on fabricated sensor data)")
                sensor = np.zeros((n, 1, 1), np.float32)
            elif len(sensor) != n:
                raise ValueError(
                    f"skeleton has {n} windows but sensor has {len(sensor)} — "
                    "the streams pair by index; counts must match")
            if n == 0:
                return np.zeros((0, self.config.data.num_classes), np.float32)
            outs = []
            for start in range(0, n, self.batch_size):
                with span("predict.prep"):
                    sk = np.asarray(skeleton[start: start + self.batch_size], np.float32)
                    se = np.asarray(sensor[start: start + self.batch_size], np.float32)
                    pad = self.batch_size - len(sk)
                    if pad:
                        sk = np.concatenate([sk, np.repeat(sk[-1:], pad, axis=0)])
                        se = np.concatenate([se, np.repeat(se[-1:], pad, axis=0)])
                    sk, se = torch.from_numpy(sk), torch.from_numpy(se)
                with span("predict.h2d"):
                    sk, se = sk.to(self.device), se.to(self.device)
                with span("predict.launch"):
                    logits = self.forward(sk, se)
                with span("predict.d2h"):
                    logits = logits.cpu()
                outs.append(logits.numpy()[: self.batch_size - pad])
            return np.concatenate(outs)

    def predict_proba(self, skeleton, sensor=None) -> np.ndarray:
        logits = torch.from_numpy(self.predict_logits(skeleton, sensor))
        return torch.softmax(logits, dim=-1).numpy()

    def predict(self, skeleton, sensor=None) -> np.ndarray:
        return self.predict_logits(skeleton, sensor).argmax(-1)


def checkpoint_state_dict(checkpoint_dir: str, which: str = "best",
                          device="cuda") -> Dict[str, torch.Tensor]:
    """The model weights of a checkpoint directory the port's trainer wrote,
    loaded onto ``device``: ``which`` is ``"best"`` or ``"latest"``, read
    through :meth:`~fall_multimodal_tpu_torch.utils.checkpoint.Checkpointer.file`
    (its ``.prev`` copy after a crash inside a save)."""
    from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

    if which not in ("best", "latest"):
        raise ValueError(f"which={which!r}: a checkpoint directory holds 'best' and "
                         "'latest'")
    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint_dir!r}")
    path = Checkpointer(checkpoint_dir).file(which)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{checkpoint_dir!r} holds no {which!r} checkpoint")
    payload = torch.load(path, map_location=resolve_device(device), weights_only=True)
    return payload["model"]


def export_pt2(config: Config, state_dict: Mapping[str, Any],
               skeleton_shape: Tuple[int, ...], sensor_shape: Tuple[int, ...],
               device="cuda") -> bytes:
    """The plain eval forward of ``config``'s model holding ``state_dict``,
    exported by ``torch.export`` at fixed input shapes on ``device`` and
    serialised as ``.pt2`` bytes (weights included). The kernels are not in
    the program: it runs the model's own modules, as the JAX package's
    ``export_stablehlo`` exports its plain ``model.apply``."""
    dev = resolve_device(device)
    model = load_into(build_model(config), state_dict).to(dev).eval()
    args = (torch.zeros(skeleton_shape, device=dev), torch.zeros(sensor_shape, device=dev))
    with torch.no_grad():
        program = torch.export.export(model, args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_pt2(blob: bytes) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The forward of :func:`export_pt2`'s bytes as a callable
    ``(skeleton, sensor) -> logits`` on the device it was exported on. It
    runs in full float32 (:func:`full_float32`) whatever the process-wide
    TF32 switches say, as :meth:`Predictor.forward` does."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def forward(skeleton: torch.Tensor, sensor: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_float32():
            return module(skeleton, sensor)

    return forward


class StreamingClassifier:
    """Online sliding-window classifier over a live frame stream.

    Push one frame (pose (V, C) [+ sensor (S,)]) at a time; once ``seq_len``
    frames accumulate, every push classifies the trailing window through a
    batch-1 view of the predictor. ``smooth`` > 1 majority-votes over the
    last k decisions.
    """

    def __init__(self, predictor: Predictor, seq_len: int = 30, smooth: int = 1):
        self.predictor = predictor.with_batch_size(1)
        self.seq_len = seq_len
        self.smooth = max(1, smooth)
        self._pose: list = []
        self._sensor: list = []
        self._votes: list = []

    def reset(self) -> None:
        self._pose.clear()
        self._sensor.clear()
        self._votes.clear()

    def push(self, pose_frame: np.ndarray,
             sensor_frame: Optional[np.ndarray] = None) -> Optional[int]:
        # pose and sensor buffers advance in lockstep: a push that omits (or
        # adds) a sensor frame would misalign the two windows
        if sensor_frame is None:
            if self.predictor.requires_sensor:
                raise ValueError(
                    f"model {self.predictor.config.model.name!r} consumes "
                    "the sensor stream; every push needs a sensor_frame")
            if self._sensor:
                raise ValueError(
                    "inconsistent stream: earlier pushes carried "
                    "sensor_frame, this one does not")
        else:
            if len(self._sensor) != len(self._pose):
                raise ValueError(
                    "inconsistent stream: earlier pushes omitted sensor_frame")
            self._sensor.append(np.asarray(sensor_frame, np.float32))
        self._pose.append(np.asarray(pose_frame, np.float32))
        if len(self._pose) < self.seq_len:
            return None
        self._pose = self._pose[-self.seq_len:]
        self._sensor = self._sensor[-self.seq_len:]
        skel = np.stack(self._pose)[None]                 # (1, T, V, C)
        sensor = np.stack(self._sensor)[None] if self._sensor else None
        pred = int(self.predictor.predict(skel, sensor)[0])
        self._votes.append(pred)
        self._votes = self._votes[-self.smooth:]
        return int(np.bincount(self._votes).argmax())


def measure_push_latency(classifier: StreamingClassifier, n_pushes: int = 200,
                         warmup: int = 20, n_joints: int = 14, in_channels: int = 3,
                         sensor_dim: Optional[int] = None,
                         seed: int = 0) -> Dict[str, float]:
    """Per-push latency of the streaming path (p50/p90/p99/mean, ms), host
    clock around each push, with the card synchronised before every read
    of the clock."""
    import time

    rng = np.random.default_rng(seed)
    device = classifier.predictor.device

    def frame():
        pose = rng.normal(size=(n_joints, in_channels)).astype(np.float32)
        sens = (rng.normal(size=(sensor_dim,)).astype(np.float32)
                if sensor_dim else None)
        return pose, sens

    classifier.reset()
    for _ in range(classifier.seq_len + warmup):
        classifier.push(*frame())

    samples = []
    for _ in range(n_pushes):
        pose, sens = frame()
        synchronize(device)
        t0 = time.perf_counter()
        classifier.push(pose, sens)
        synchronize(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    arr = np.asarray(samples)
    return {
        "p50_ms": float(np.percentile(arr, 50)),
        "p90_ms": float(np.percentile(arr, 90)),
        "p99_ms": float(np.percentile(arr, 99)),
        "mean_ms": float(arr.mean()),
        "n": int(arr.size),
    }


def load_input(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``(skeleton, sensor or None)`` windows of a ``predict --input`` file:
    an ``.npz`` with ``skeleton`` (N,T,V,C) [and ``sensor`` (N,T,S)], a bare
    ``.npy`` of skeleton windows, or a prep-pipeline pickle
    (:func:`~fall_multimodal_tpu_torch.data.loaders.load_pickle_windows`;
    pickles run code when read: load only files this pipeline wrote)."""
    if path.endswith(".npz"):
        with np.load(path) as blob:
            return blob["skeleton"], (blob["sensor"] if "sensor" in blob.files else None)
    if path.endswith(".npy"):
        return np.load(path), None
    from fall_multimodal_tpu_torch.data import load_pickle_windows

    data = load_pickle_windows(path)
    return data.features, data.sensors


def main(argv=None):
    """Serving CLI:

        python -m fall_multimodal_tpu_torch.serve predict \\
            --config gstcan_urfall_3stream --checkpoint outputs/run/ckpt/fold0 \\
            [--which best] --input windows.npz --output predictions.csv [--proba]

        python -m fall_multimodal_tpu_torch.serve latency \\
            --config gstcan_urfall_3stream --checkpoint best_model.pt

        python -m fall_multimodal_tpu_torch.serve export \\
            --config gstcan_urfall_3stream --checkpoint outputs/run/ckpt \\
            --output model.pt2 [--batch-size 128] [--sensor-dim 4]

        python -m fall_multimodal_tpu_torch.serve serve \\
            --config gstcan_urfall_3stream --checkpoint best_model.pt --port 8000

    ``--checkpoint`` is a checkpoint directory of the port's trainer (with
    ``--which best|latest``) or a reference checkpoint file
    (``.pt``/``.pth``/``.npz``; a JAX checkpoint converted by
    ``experiments/convert_jax_checkpoint.py`` is such an ``.npz``).
    ``--input`` is an ``.npz``, ``.npy`` or prep-pipeline pickle
    (:func:`load_input`). ``--config`` names any preset of a registered family
    (e.g. ``default_urfall`` for the single-stream ``stgcan``, ``musa_harup``
    for a Gen-3 ``best_model.pt``), or the ``config.json`` a training run
    leaves in its output dir. ``--num-copies k`` serves the Gen-3 k-copies
    rule. ``--device cpu`` runs on the CPU; the default is the card.
    """
    import argparse
    import csv
    import json

    from fall_multimodal_tpu_torch.configs import load_config, preset_path

    p = argparse.ArgumentParser(prog="fall_multimodal_tpu_torch.serve")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(s):
        s.add_argument("--config", required=True, help="preset name or YAML/JSON path")
        s.add_argument("--checkpoint", required=True,
                       help="checkpoint dir of the port's trainer, or a reference "
                            "checkpoint file (.pt/.pth/.npz)")
        s.add_argument("--which", default="best", choices=["best", "latest"],
                       help="which checkpoint of a checkpoint dir")
        s.add_argument("--batch-size", type=int, default=128)
        s.add_argument("--device", default="cuda")
        s.add_argument("--num-copies", type=int, default=1,
                       help="k-copies inference: mean logits of k time slices of each "
                            "window (reference Multimodal_Fall3/main.py:150-161)")

    s = sub.add_parser("predict", help="batch inference over saved windows")
    common(s)
    s.add_argument("--input", required=True)
    s.add_argument("--output", default="predictions.csv")
    s.add_argument("--proba", action="store_true",
                   help="also write per-class probabilities")

    s = sub.add_parser("latency", help="measure streaming p50/p99 push latency")
    common(s)
    s.add_argument("--pushes", type=int, default=200)

    s = sub.add_parser("export", help="save the plain eval forward as a torch.export "
                                      "program (.pt2) at --batch-size")
    common(s)
    s.add_argument("--output", default="model.pt2")
    s.add_argument("--sensor-dim", type=int, default=None)

    s = sub.add_parser("serve", help="HTTP JSON prediction endpoint "
                                     "(GET /healthz, POST /v1/predict)")
    common(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)

    args = p.parse_args(argv)
    cfg = load_config(args.config if os.path.exists(args.config)
                      else preset_path(args.config))
    d = cfg.data

    def make_predictor():
        kw = dict(batch_size=args.batch_size, device=args.device, num_copies=args.num_copies)
        if os.path.isdir(args.checkpoint):
            return Predictor.from_checkpoint(cfg, args.checkpoint, which=args.which, **kw)
        return Predictor.from_torch_checkpoint(cfg, args.checkpoint, **kw)

    if args.cmd == "predict":
        skeleton, sensor = load_input(args.input)
        if sensor is None and uses_sensor(cfg.model.name):
            raise SystemExit(
                f"model {cfg.model.name!r} consumes the sensor stream but "
                f"{args.input!r} has no sensor array; provide an .npz with "
                "both 'skeleton' and 'sensor', or a prep-pipeline pickle")
        proba = make_predictor().predict_proba(skeleton, sensor)
        classes = proba.argmax(-1)
        with open(args.output, "w", newline="") as fh:
            writer = csv.writer(fh)
            header = ["index", "prediction"]
            if args.proba:
                header += [f"p{k}" for k in range(proba.shape[1])]
            writer.writerow(header)
            for i, c in enumerate(classes):
                row = [i, int(c)]
                if args.proba:
                    row += [f"{v:.6f}" for v in proba[i]]
                writer.writerow(row)
        print(f"wrote {args.output}: {len(classes)} predictions, "
              f"{proba.shape[1]} classes")
        return {"n": len(classes), "output": args.output}

    if args.cmd == "export":
        dev = resolve_device(args.device)
        state_dict = (checkpoint_state_dict(args.checkpoint, args.which, dev)
                      if os.path.isdir(args.checkpoint)
                      else load_state_dict_file(args.checkpoint))
        skel_shape = (args.batch_size, d.seq_len, d.num_joints, d.in_channels)
        sens_shape = (args.batch_size, d.seq_len, args.sensor_dim or d.sensor_dim)
        blob = export_pt2(cfg, state_dict, skel_shape, sens_shape, device=dev)
        with open(args.output, "wb") as fh:
            fh.write(blob)
        print(f"wrote {args.output}: {len(blob)} bytes of torch.export program "
              f"(batch {args.batch_size}, {dev})")
        return {"bytes": len(blob), "output": args.output}

    pred = make_predictor()

    if args.cmd == "serve":
        from fall_multimodal_tpu_torch.server import make_server

        skel = np.zeros((1, d.seq_len, d.num_joints, d.in_channels), np.float32)
        sens = np.zeros((1, d.seq_len, d.sensor_dim), np.float32)
        # build the kernels before accepting traffic
        pred.predict_logits(skel, sens if pred.requires_sensor else None)
        srv = make_server(pred, host=args.host, port=args.port, quiet=False)
        print(f"serving {cfg.model.name} on http://{srv.host}:{srv.port} "
              f"(POST /v1/predict, GET /healthz)", flush=True)
        srv.serve()
        return {"host": srv.host, "port": srv.port}

    stream = StreamingClassifier(pred, seq_len=d.seq_len)
    stats = measure_push_latency(
        stream, n_pushes=args.pushes, n_joints=d.num_joints,
        in_channels=d.in_channels,
        sensor_dim=d.sensor_dim if pred.requires_sensor else None)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
