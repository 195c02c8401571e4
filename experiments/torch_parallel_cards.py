"""Data parallelism and the fold mesh of the PyTorch port across the cards of
one host, each against its one-card run, through the trainer's CLI.

    python3 experiments/torch_parallel_cards.py --cards 4          # on 4 cards
    python3 experiments/torch_parallel_cards.py --cards 2 --device cpu \\
        --set 'model.kwargs.stages=[[16,1,false],[16,1,true],[32,2,true]]'

1. ``--mesh``: the flagship (``gstcan_urfall_3stream``, full width unless
   ``--set`` narrows it) trains ``--epochs`` epochs at its batch of 32 on
   ``--windows`` synthetic windows in one process, then in ``--cards``
   processes (``torchrun --nproc-per-node N ... --distributed --mesh N``,
   NCCL on the cards, gloo on the CPU) at the same global batch. Prints both
   runs' curves, their largest differences, seconds and the epochs' train
   windows/s in all and per card.
2. ``--cv-mesh``: ``--cv-vmapped --folds N`` on one card and with
   ``--cv-mesh N`` (one fold a card, one process): seconds and the largest
   difference of the per-fold results.

Prints the card's name and power limit; writes everything as JSON to
``chiprun_out/torch_parallel_cards.json``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = ("train_loss", "train_acc", "val_loss", "val_acc")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cmd, env):
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr[-4000:]}")
    return seconds


def _train_windows(args) -> int:
    """Windows a run trains an epoch: the CLI's train split, whole batches."""
    sys.path.insert(0, ROOT)
    from fall_multimodal_tpu_torch.configs import load_config, preset_path
    from fall_multimodal_tpu_torch.data import load_dataset, split_dataset

    cfg = load_config(preset_path("gstcan_urfall_3stream"),
                      overrides=dict(item.partition("=")[::2] for item in args.set))
    d = cfg.data
    data = load_dataset(d.dataset, seq_len=d.seq_len, num_joints=d.num_joints,
                        num_classes=d.num_classes, sensor_dim=d.sensor_dim, seed=cfg.seed,
                        n_windows=args.windows)
    n = len(split_dataset(data, split=d.split, seed=cfg.seed, by_video=d.split_by_video)["train"])
    return n // cfg.train.batch_size * cfg.train.batch_size


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--windows", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "torch_parallel_cards.json"))
    args = p.parse_args(argv)
    card = "cpu"
    if args.device != "cpu":
        import torch

        if torch.cuda.device_count() < args.cards:
            print(f"needs {args.cards} CUDA devices, has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    n = args.cards
    work = os.path.join(ROOT, "outputs", "parallel_cards")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "4"))
    base = ["--config", "gstcan_urfall_3stream", "--device", args.device,
            "--synthetic-windows", str(args.windows), "--epochs", str(args.epochs)]
    for item in args.set:
        base += ["--set", item]
    cli = [sys.executable, "-m", "fall_multimodal_tpu_torch.cli"]
    report = {"card": card, "cards": n, "epochs": args.epochs, "windows": args.windows,
              "set": args.set}

    one_dir, many_dir = os.path.join(work, "one"), os.path.join(work, f"mesh{n}")
    one_s = _run(cli + base + ["--output-dir", one_dir],
                 dict(env, CUDA_VISIBLE_DEVICES="0") if args.device != "cpu" else env)
    many_s = _run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
                   "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
                   "-m", "fall_multimodal_tpu_torch.cli", *base, "--distributed",
                   "--mesh", str(n), "--output-dir", many_dir], env)
    hist = []
    for d in (one_dir, many_dir):
        with open(os.path.join(d, "history.json")) as fh:
            hist.append(json.load(fh))
    train_windows = _train_windows(args)
    diffs = {k: max(abs(a - b) for a, b in zip(hist[0][k], hist[1][k])) for k in CURVES}
    rate = [train_windows * args.epochs / sum(h["epoch_time"]) for h in hist]
    report["mesh"] = {"one_process": {k: hist[0][k] for k in (*CURVES, "epoch_time")},
                      f"{n}_processes": {k: hist[1][k] for k in (*CURVES, "epoch_time")},
                      "max_abs_diff": diffs, "one_s": one_s, "mesh_s": many_s,
                      "train_windows_per_s_of_epoch_time": {"one": rate[0],
                                                            f"mesh{n}": rate[1],
                                                            f"mesh{n}_per_card": rate[1] / n}}
    print(f"--mesh {n}: one process {one_s:.2f} s, {n} processes {many_s:.2f} s; train "
          f"windows/s of epoch time {rate[0]:.1f} -> {rate[1]:.1f} ({rate[1] / n:.1f} a card); "
          f"curves max abs diff {diffs} [{card}]", flush=True)

    results = []
    for extra in ([], ["--cv-mesh", str(n)]):
        out = os.path.join(work, "cv" + "".join(extra).replace("-", ""))
        s = _run(cli + base + ["--cv-vmapped", "--folds", str(n), *extra, "--output-dir", out],
                 env)
        with open(os.path.join(out, "cv_results.json")) as fh:
            results.append((s, json.load(fh)))
    diff = max(abs(a[m] - b[m]) for a, b in zip(results[0][1]["folds"], results[1][1]["folds"])
               for m in a)
    report["cv_mesh"] = {"one_card_s": results[0][0], f"cv_mesh{n}_s": results[1][0],
                         "max_abs_diff": diff, "folds": results[1][1]["folds"]}
    print(f"--cv-vmapped --folds {n}: one card {results[0][0]:.2f} s, --cv-mesh {n} "
          f"{results[1][0]:.2f} s; per-fold results max abs diff {diff:.3e} [{card}]",
          flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps({k: report[k] for k in ("card", "cards")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
