"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fall_multimodal_tpu_torch/ops/csrc``,
holds each kernel against its plain PyTorch version at every shape the
flagship's serving path gives it, serves the reference checkpoint and a
seeded random flagship (``gstcan_urfall_3stream``, full widths, batch 128)
through ``Predictor`` and the HTTP server, and prints timings. Any failed
check raises. The second-to-last line is a JSON object describing each
kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.interop import load_state_dict_file
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.ops import build
from fall_multimodal_tpu_torch.ops.stgcan_block import (
    fused_stgcan_block,
    stgcan_block_reference,
)
from fall_multimodal_tpu_torch.serve import (
    Predictor,
    StreamingClassifier,
    measure_push_latency,
)
from fall_multimodal_tpu_torch.server import PredictionServer

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "reference_gstcan3.npz")
BATCH = 128
SEED = 0
KERNEL_TOL = 1e-4        # fp32 kernel vs fp32 plain version, other summation order
MODEL_TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, HBM3 bandwidth. The kernel runs plain fp32 FMAs.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_cost(n, t, v, cin, folded, stride, mode):
    """(flops, bytes) one block call must do/move: each input and weight
    read once, the output written once."""
    k, c = folded.A.shape[0], folded.bn1_scale.shape[0]
    h = c // 4
    t_out = (t - 1) // stride + 1
    flops = 2 * n * (t * v * k * cin * c            # channel mix
                     + t * k * v * v * cin          # adjacency contraction
                     + t_out * v * 9 * c * c        # temporal taps
                     + 2 * c * h)                   # SE MLP
    if mode == "proj":
        flops += 2 * n * t_out * v * cin * c
    weights = sum(x.numel() for x in folded if x is not None)
    nbytes = 4 * (n * t * v * cin + n * t_out * v * c + weights)
    return flops, nbytes


def block_shapes(pred):
    """Every block call of one flagship forward: (stream, index, T, folded,
    stride, mode), following T through both streams."""
    d = pred.config.data
    calls = []
    for stream, fb, t in (("pts", pred.pts_fb, d.seq_len), ("mot", pred.mot_fb, d.seq_len - 1)):
        for i, (folded, stride, mode) in enumerate(fb.blocks):
            calls.append((stream, i, t, folded, stride, mode))
            t = (t - 1) // stride + 1
    return calls


def seeded_state_dict(cfg):
    """Random flagship weights from SEED, with non-trivial BN statistics.
    Conv and linear weights are scaled from torch's default init to He's
    variance (2 / fan_in), so activations keep O(1) through both streams."""
    torch.manual_seed(SEED)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if param.dim() >= 2 and "lstm" not in name:
                param.mul_(6 ** 0.5)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.3 * torch.rand(buf.shape, generator=gen))
    return model.state_dict()


def http_json(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- phase 1: build every kernel from source ---------------------------
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report) or 'cached'}")
    for name, info in report.items():
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    rng = np.random.default_rng(SEED)
    sd_random = seeded_state_dict(cfg)
    pred = Predictor(cfg, sd_random, batch_size=BATCH, device=dev)
    calls = block_shapes(pred)

    # ---- phase 2: the kernel against its plain version, every shape --------
    distinct = {}
    for stream, i, t, folded, stride, mode in calls:
        cin = folded.gcn_w.shape[0]
        key = (cin, folded.bn1_scale.shape[0], t, stride, mode)
        distinct.setdefault(key, []).append((stream, i, folded))
    max_err = 0.0
    per_shape = {}
    for key, users in distinct.items():
        cin, c, t, stride, mode = key
        folded = users[0][2]
        for n in (BATCH, 1, 37):
            x = torch.from_numpy(rng.normal(size=(n, t, 14, cin)).astype(np.float32)).to(dev)
            out = fused_stgcan_block(x, folded, stride=stride, residual_mode=mode)
            torch.cuda.synchronize()
            ref = stgcan_block_reference(x, folded, stride, mode)
            err = (out - ref).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= KERNEL_TOL
            log(f"check stgcan_block Cin={cin} C={c} T={t} stride={stride} {mode:8s} "
                f"N={n:3d}: max_abs_err={err:.3e} ({'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(f"stgcan_block disagrees at {key}, N={n}: {err}")
            max_err = max(max_err, err)
            if n == BATCH:
                per_shape[key] = x

    # ---- phase 3: the reference checkpoint served on the card --------------
    sd_ref = load_state_dict_file(FIXTURE)
    g = np.load(FIXTURE)
    ref_pred = Predictor(cfg, sd_ref, batch_size=BATCH, device=dev)
    skel_fx = np.ascontiguousarray(np.transpose(g["x"], (0, 2, 3, 1)))
    proba = ref_pred.predict_proba(skel_fx, g["sensor"])
    err_fx = float(np.abs(proba - g["out"]).max())
    log(f"reference checkpoint: softmax vs fixture out max_abs_err={err_fx:.3e}")
    if not err_fx <= MODEL_TOL:
        raise AssertionError(f"reference checkpoint output off by {err_fx}")

    # ---- phase 4: the main path, seeded weights, batch 128 -----------------
    d = cfg.data
    skel = rng.normal(size=(BATCH, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(BATCH, d.seq_len, d.sensor_dim)).astype(np.float32)
    fused_stgcan_block.launches = 0
    logits = pred.predict_logits(skel, sens)
    launches = fused_stgcan_block.launches
    log(f"main path: Predictor(batch {BATCH}) forward launched stgcan_block {launches} times")
    if launches != len(calls) or launches != 14:
        raise AssertionError(f"expected 14 stgcan_block launches per forward, saw {launches}")
    cpu_logits = Predictor(cfg, sd_random, batch_size=BATCH, device="cpu").predict_logits(
        skel, sens)
    err_cpu = float(np.abs(logits - cpu_logits).max())
    log(f"main path logits {logits.shape}, finite={np.isfinite(logits).all()}, "
        f"vs CPU max_abs_err={err_cpu:.3e} (|logits| max {np.abs(logits).max():.3f})")
    if logits.shape != (BATCH, d.num_classes) or not np.isfinite(logits).all() \
            or not err_cpu <= MODEL_TOL:
        raise AssertionError(f"main path logits disagree with the CPU run: {err_cpu}")

    # ---- phase 5: the HTTP server ------------------------------------------
    srv = PredictionServer(pred, host="127.0.0.1", port=0).start()
    try:
        health = http_json(f"http://127.0.0.1:{srv.port}/healthz")
        if health.get("status") != "ok":
            raise AssertionError(f"healthz answered {health}")
        for n in (1, 5, 200):
            sk, se = (rng.normal(size=(n, d.seq_len, d.num_joints, d.in_channels)).astype(
                np.float32), rng.normal(size=(n, d.seq_len, d.sensor_dim)).astype(np.float32))
            got = http_json(f"http://127.0.0.1:{srv.port}/v1/predict",
                            {"skeleton": sk.tolist(), "sensor": se.tolist(), "proba": True})
            want = pred.predict_proba(sk, se)
            err = float(np.abs(np.asarray(got["probabilities"]) - want).max())
            log(f"server: POST {n} windows -> n={got['n']}, max_abs_err={err:.3e}")
            if got["n"] != n or got["predictions"] != want.argmax(-1).tolist() or err > 1e-6:
                raise AssertionError(f"server answer for {n} windows disagrees ({err})")
    finally:
        srv.close()

    # ---- phase 6: timings ----------------------------------------------------
    kernel_ms = plain_ms = bound_ms = flop_ms = byte_ms = 0.0
    uses = {}
    for stream, i, t, folded, stride, mode in calls:
        key = (folded.gcn_w.shape[0], folded.bn1_scale.shape[0], t, stride, mode)
        uses[key] = uses.get(key, 0) + 1
    for key, x in per_shape.items():
        cin, c, t, stride, mode = key
        folded = distinct[key][0][2]
        k_ms = cuda_ms(lambda: fused_stgcan_block(x, folded, stride, mode))
        p_ms = cuda_ms(lambda: stgcan_block_reference(x, folded, stride, mode))
        flops, nbytes = block_cost(BATCH, t, 14, cin, folded, stride, mode)
        b_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"time stgcan_block Cin={cin} C={c} T={t} stride={stride} {mode:8s} N={BATCH} "
            f"x{uses[key]}/forward: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"{flops / k_ms / 1e9:.1f} TFLOP/s")
        kernel_ms += uses[key] * k_ms
        plain_ms += uses[key] * p_ms
        bound_ms += uses[key] * b_ms
        flop_ms += uses[key] * flops / PEAK_FP32_FLOPS * 1e3
        byte_ms += uses[key] * nbytes / PEAK_BYTES * 1e3
    log(f"stgcan_block per forward (14 launches, batch {BATCH}): kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")

    skel_d = torch.from_numpy(skel).to(dev)
    sens_d = torch.from_numpy(sens).to(dev)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.forward(skel_d, sens_d))
    for _ in range(3):
        pred.predict_logits(skel, sens)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_logits(skel, sens)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    log(f"Predictor batch {BATCH}: device {fwd_ms:.3f} ms/forward (events), "
        f"host {host_ms:.3f} ms/call incl. copies -> {BATCH / host_ms * 1e3:.0f} windows/s")
    lat = measure_push_latency(StreamingClassifier(pred, seq_len=d.seq_len), n_pushes=50,
                               warmup=5, sensor_dim=d.sensor_dim)
    log(f"streaming push latency (batch 1, {lat['n']} pushes): p50 {lat['p50_ms']:.3f} ms, "
        f"p99 {lat['p99_ms']:.3f} ms")

    log(json.dumps({"kernels": [{
        "name": "stgcan_block",
        "route": "cuda",
        "source": "fall_multimodal_tpu_torch/ops/csrc/stgcan_block.cu",
        "replaces": "fall_multimodal_tpu/ops/pallas/stgcan_block.py:62",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
