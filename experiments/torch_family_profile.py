"""Where the time of the Gen-3 and Gen-1 families goes on one NVIDIA GPU:
a batch-128 serving forward and a train step at the preset's batch.

    python3 experiments/torch_family_profile.py [--steps 3] [--out chiprun_out/family_profile.json]

For ``musa_harup``, ``targcn_harup``, ``skeleton_transformer_harup`` and
``transformer_ensemble_harup`` (full widths, seeded init, synthetic windows
on the device): the serving forward (``Predictor.forward``, eval, full
float32) and a float32 train step (``make_train_step``) run ``--steps``
times under ``torch.profiler`` after a warm-up. Prints, per call, the host
time (synchronised wall clock, unprofiled), the device-busy time (summed
device activities), the kernel launches and aten calls, and the kernels
that take the most device time; writes the same to ``--out`` as JSON.

Prints the card's name and power limit first. Needs a card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PRESETS = ("musa_harup", "targcn_harup", "skeleton_transformer_harup",
           "transformer_ensemble_harup")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperative")


def profiled(fn, steps):
    """(host ms a call unprofiled, device-busy ms a call, kernel launches a
    call, aten calls a call, top kernels by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
    launches = sum(1 for e in events if e.name.startswith(LAUNCHES)) / steps
    aten = sum(1 for e in events if e.name.startswith("aten::")) / steps
    by_name = {}
    for e in device:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / steps, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return host_ms, busy, launches, aten, [
        {"kernel": k[:90], "ms": v[0], "calls": v[1] / steps} for k, v in top]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default="chiprun_out/family_profile.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from fall_multimodal_tpu_torch.configs import load_config, preset_path
    from fall_multimodal_tpu_torch.data import gather_batch, make_synthetic, to_device
    from fall_multimodal_tpu_torch.serve import Predictor
    from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    rows = []
    for preset in PRESETS:
        cfg = load_config(preset_path(preset))
        d = cfg.data
        data = to_device(make_synthetic(n_windows=512, num_classes=d.num_classes,
                                        sensor_dim=d.sensor_dim, seed=0), dev)
        state = create_train_state(cfg, build_optimizer(cfg), seed=0, device=dev)
        pred = Predictor(cfg, state.model.state_dict(), batch_size=128, device=dev)
        x, s = data.features[:128], data.sensors[:128]
        with torch.inference_mode():
            serve = profiled(lambda: pred.forward(x, s), args.steps)
        batch = gather_batch(data, torch.arange(cfg.train.batch_size, device=dev))
        step = make_train_step()
        train = profiled(lambda: step(state, batch), args.steps)
        for kind, (host, busy, launches, aten, top), n in (
                ("serve", serve, 128), ("train", train, cfg.train.batch_size)):
            print(f"{preset} {kind} batch {n}: host {host:.3f} ms, device busy {busy:.3f} ms "
                  f"(share {busy / host:.3f}), {launches:.0f} kernel launches, {aten:.0f} aten "
                  f"calls a call; top kernels: "
                  + "; ".join(f"{t['kernel'][:60]} {t['ms']:.3f} ms x{t['calls']:.0f}"
                              for t in top[:5]), flush=True)
            rows.append({"preset": preset, "kind": kind, "batch": n, "host_ms": host,
                         "device_busy_ms": busy, "kernel_launches": launches,
                         "aten_calls": aten, "top": top, "card": card})
        del state, pred
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    print(f"[{card}] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
