"""Serving layer of the port: checkpoint -> predictor -> streaming classifier.

Counterpart of ``fall_multimodal_tpu/serve.py``:

* :class:`Predictor` — loads weights into the model, folds each STGCAN
  stream into a :class:`~fall_multimodal_tpu_torch.ops.fused_backbone.
  FusedBackbone` (every block through the fused STGCAN-block kernel), pads
  ragged requests to ``batch_size`` and chunks larger ones;
* :class:`StreamingClassifier` — online sliding-window inference over a
  live pose/sensor stream;
* :func:`measure_push_latency` and the ``predict | latency | serve`` CLI.

Everything runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card and no explicit CPU request it raises.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.interop import load_into, load_state_dict_file
from fall_multimodal_tpu_torch.models import ThreeStreamGSTCAN, build_model, uses_sensor
from fall_multimodal_tpu_torch.models.stgcan import motion_stream
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Predictor:
    """Fixed-batch predictor around a trained three-stream model.

    ``state_dict`` holds the model's weights under the reference names
    (arrays or tensors). Smaller requests are padded to ``batch_size`` by
    repeating the last window, larger ones chunked.
    """

    def __init__(self, config: Config, state_dict: Mapping[str, Any],
                 batch_size: int = 128, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.requires_sensor = uses_sensor(config.model.name)
        model = build_model(config)
        if not isinstance(model, ThreeStreamGSTCAN):
            raise NotImplementedError(
                f"the port serves ThreeStreamGSTCAN families; got {type(model).__name__}")
        self.model = load_into(model, state_dict).to(self.device).eval()
        self.pts_fb = FusedBackbone(self.model.pts_stream)
        self.mot_fb = FusedBackbone(self.model.mot_stream)

    def with_batch_size(self, batch_size: int) -> "Predictor":
        """A predictor over the same model and folded weights at another
        batch size (e.g. batch 1 for streaming)."""
        if batch_size == self.batch_size:
            return self
        other = copy.copy(self)
        other.batch_size = batch_size
        return other

    @classmethod
    def from_torch_checkpoint(cls, config: Config, path: str, **kwargs) -> "Predictor":
        """Serve a reference checkpoint file (``.pt``/``.pth``/``.npz``)."""
        return cls(config, load_state_dict_file(path), **kwargs)

    def forward(self, skeleton: torch.Tensor, sensor: torch.Tensor) -> torch.Tensor:
        """Logits of one batch already on the device."""
        pts = self.pts_fb(skeleton)
        mot = self.mot_fb(motion_stream(skeleton).contiguous())
        sen = self.model.sensor(sensor)
        return self.model.fcn(torch.cat([pts, mot, sen], dim=-1))

    @torch.inference_mode()
    def predict_logits(self, skeleton: np.ndarray,
                       sensor: Optional[np.ndarray] = None) -> np.ndarray:
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
            sk = np.asarray(skeleton[start: start + self.batch_size], np.float32)
            se = np.asarray(sensor[start: start + self.batch_size], np.float32)
            pad = self.batch_size - len(sk)
            if pad:
                sk = np.concatenate([sk, np.repeat(sk[-1:], pad, axis=0)])
                se = np.concatenate([se, np.repeat(se[-1:], pad, axis=0)])
            logits = self.forward(torch.from_numpy(sk).to(self.device),
                                  torch.from_numpy(se).to(self.device))
            outs.append(logits.cpu().numpy()[: self.batch_size - pad])
        return np.concatenate(outs)

    def predict_proba(self, skeleton, sensor=None) -> np.ndarray:
        logits = torch.from_numpy(self.predict_logits(skeleton, sensor))
        return torch.softmax(logits, dim=-1).numpy()

    def predict(self, skeleton, sensor=None) -> np.ndarray:
        return self.predict_logits(skeleton, sensor).argmax(-1)


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


def main(argv=None):
    """Serving CLI on reference checkpoints (``.pt``/``.pth``/``.npz``):

        python -m fall_multimodal_tpu_torch.serve predict \\
            --config gstcan_urfall_3stream --checkpoint best_model.pt \\
            --input windows.npz --output predictions.csv [--proba]

        python -m fall_multimodal_tpu_torch.serve latency \\
            --config gstcan_urfall_3stream --checkpoint best_model.pt

        python -m fall_multimodal_tpu_torch.serve serve \\
            --config gstcan_urfall_3stream --checkpoint best_model.pt --port 8000

    ``--input`` is an .npz with ``skeleton`` (N,T,V,C) and ``sensor``
    (N,T,S). ``--device cpu`` runs on the CPU; the default is the card.
    """
    import argparse
    import csv
    import json
    import os

    from fall_multimodal_tpu_torch.configs import load_config, preset_path

    p = argparse.ArgumentParser(prog="fall_multimodal_tpu_torch.serve")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(s):
        s.add_argument("--config", required=True, help="preset name or YAML path")
        s.add_argument("--checkpoint", required=True,
                       help="reference checkpoint file (.pt/.pth/.npz)")
        s.add_argument("--batch-size", type=int, default=128)
        s.add_argument("--device", default="cuda")

    s = sub.add_parser("predict", help="batch inference over saved windows")
    common(s)
    s.add_argument("--input", required=True)
    s.add_argument("--output", default="predictions.csv")
    s.add_argument("--proba", action="store_true",
                   help="also write per-class probabilities")

    s = sub.add_parser("latency", help="measure streaming p50/p99 push latency")
    common(s)
    s.add_argument("--pushes", type=int, default=200)

    s = sub.add_parser("serve", help="HTTP JSON prediction endpoint "
                                     "(GET /healthz, POST /v1/predict)")
    common(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)

    args = p.parse_args(argv)
    cfg = load_config(args.config if os.path.exists(args.config)
                      else preset_path(args.config))
    pred = Predictor.from_torch_checkpoint(cfg, args.checkpoint,
                                           batch_size=args.batch_size,
                                           device=args.device)
    d = cfg.data

    if args.cmd == "predict":
        with np.load(args.input) as blob:
            skeleton = blob["skeleton"]
            sensor = blob["sensor"] if "sensor" in blob.files else None
        proba = pred.predict_proba(skeleton, sensor)
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
