"""Where a flagship train step of the PyTorch port spends its time, and how
far its float32 gradients sit from float64, on one NVIDIA GPU.

    python3 experiments/torch_train_profile.py [--batch 32] [--steps 5] [--folds 1]

1. Profile: the full-width flagship (``gstcan_urfall_3stream``, seeded
   init) trains ``--steps`` steps at ``--batch`` in float32 and in bfloat16
   under ``torch.profiler`` (CPU and CUDA activities). Prints, per step, the
   host time, the device-busy time (summed device activities), the number of
   kernel launches (``cudaLaunchKernel`` and friends) and of aten calls, and
   the operators that take the most host time. ``--folds K`` (K > 1)
   profiles instead the fold-parallel CV step of K seeded folds
   (``train/cv_vmapped.py:make_fold_train_step``, K batches of ``--batch``)
   and also prints the kernels that take the most device time.
2. Precision: the gradient of one train-mode loss from one state (seeded
   weights, batch ``--batch``, TF32 off) in float32 on the card, float32 on
   the CPU, float64 on the card and float64 on the CPU; for each, the
   gradient's distance from the CPU's float64 gradient: global relative L2
   and the tensors with the largest max-abs error.

Prints the card's name and power limit first. Needs a card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--folds", type=int, default=1)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fall_multimodal_tpu_torch.configs import load_config, preset_path
    from fall_multimodal_tpu_torch.data import gather_batch, make_synthetic, to_device
    from fall_multimodal_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        cross_entropy,
        make_train_step,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    d = cfg.data
    data = make_synthetic(n_windows=max(4, args.folds) * args.batch,
                          num_classes=d.num_classes, sensor_dim=d.sensor_dim, seed=0)
    split = to_device(data, dev)
    idx = torch.arange(args.folds * args.batch, device=dev)

    for dtype in (None, torch.bfloat16):
        if args.folds > 1:
            from fall_multimodal_tpu_torch.train.cv_vmapped import (
                make_fold_train_step,
                stack_states,
            )

            opt = build_optimizer(cfg)
            state = stack_states([create_train_state(cfg, opt, seed=k, device=dev)
                                  for k in range(args.folds)], opt,
                                 torch.Generator(dev).manual_seed(0))
            fold_step = make_fold_train_step(softmax_before_ce=True, compute_dtype=dtype)
            rows = idx.view(args.folds, args.batch)

            def run():
                fold_step(state, split, rows)
        else:
            state = create_train_state(cfg, build_optimizer(cfg), seed=0, device=dev)
            step = make_train_step(softmax_before_ce=True, compute_dtype=dtype)
            batch = gather_batch(split, idx)

            def run():
                step(state, batch)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                run()
            torch.cuda.synchronize()
        events = prof.events()
        busy = sum(e.time_range.elapsed_us() for e in events
                   if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3
        launches = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel",
                                                               "cuLaunchKernel",
                                                               "cudaLaunchCooperative")))
        aten = sum(1 for e in events if e.name.startswith("aten::"))
        name = "float32" if dtype is None else "bfloat16"
        if args.folds > 1:
            name += f", {args.folds} folds vmapped"
        print(f"{name} batch {args.batch}: host {host_ms:.3f} ms/step (unprofiled), device "
              f"busy {busy / args.steps:.3f} ms/step, {launches / args.steps:.0f} kernel "
              f"launches and {aten / args.steps:.0f} aten calls per step [{card}]", flush=True)
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25),
              flush=True)
        if args.folds > 1:
            print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25),
                  flush=True)

    # ---- precision: one step from one state, four ways ----------------------
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    sd = create_train_state(cfg, build_optimizer(cfg), seed=3, device="cpu").model.state_dict()
    grads = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                          ("cuda", torch.float32), ("cuda", torch.float64)):
        state = create_train_state(cfg, build_optimizer(cfg), seed=0, device=device)
        state.model.load_state_dict(sd)
        state.model.to(dtype).train()
        b = gather_batch(to_device(data, device), torch.arange(args.batch, device=device))
        out = state.model(b.features.to(dtype), b.sensors.to(dtype))
        cross_entropy(out, b.labels.to(dtype), softmax_before_ce=True).backward()
        grads[(device, dtype)] = {k: p.grad.detach().double().cpu()
                                  for k, p in state.model.named_parameters()}
    ref = grads[("cpu", torch.float64)]
    ref_norm = float(torch.sqrt(sum((g ** 2).sum() for g in ref.values())))
    for key, g in grads.items():
        if key == ("cpu", torch.float64):
            continue
        l2 = float(torch.sqrt(sum(((g[k] - ref[k]) ** 2).sum() for k in ref))) / ref_norm
        worst = sorted(((float((g[k] - ref[k]).abs().max()), float(ref[k].abs().max()), k)
                        for k in ref), reverse=True)[:5]
        print(f"gradient {key[0]} {str(key[1]).split('.')[-1]} vs cpu float64: global "
              f"relative L2 {l2:.3e}; largest max-abs errors "
              + "; ".join(f"{k} {e:.2e} (|g| max {m:.2e})" for e, m, k in worst), flush=True)
    print(f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
