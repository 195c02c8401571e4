"""The K-fold CV protocol of ``PARITY.md`` ("K-fold CV protocol parity") run
by the PyTorch port on the card: the flagship ``gstcan_urfall_3stream`` at
full width, 480 synthetic windows of 6 classes (noise 0.45, 16 windows a
video), 15% of the labels flipped (``parity_training.flip_labels``),
video-level folds at seed 42 (valid == test per fold), 5 folds x 25 epochs
at batch 32, each fold trained by the port's ``run_fold`` with
``fold_seed=i``: the arm the JAX package ran in ``experiments/parity_cv.py``.
``--vmapped`` trains the same folds at once through ``cross_validate_vmapped``
(config seed 42, which draws the folds there: fold k starts from seed 42 + k,
and every epoch takes ``min fold train // 32`` steps).

    python3 experiments/torch_cv_protocol.py            # on the card
    python3 experiments/torch_cv_protocol.py --vmapped
    python3 experiments/torch_cv_protocol.py --device cpu --folds 2 --epochs 1

Prints per-fold best-val accuracy, macro F1 and wall-clock seconds, their
mean and std, and the card's name and power limit; writes the same as JSON
to ``chiprun_out/torch_cv_protocol[_vmapped].json``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from parity_training import flip_labels  # noqa: E402

# The protocol's data, fixed: JAX_RUN was taken at exactly these settings.
WINDOWS, CLASSES, NOISE, LABEL_FLIP = 480, 6, 0.45, 0.15
JAX_RUN = {"mean": 0.8542, "std": 0.0147}      # experiments/parity_cv_results.json
BAND = 0.03


def main(argv=None):
    from fall_multimodal_tpu_torch.configs import load_config, preset_path
    from fall_multimodal_tpu_torch.data import kfold_indices, make_synthetic, to_device
    from fall_multimodal_tpu_torch.train.cv import run_fold
    from fall_multimodal_tpu_torch.train.cv_vmapped import cross_validate_vmapped
    from fall_multimodal_tpu_torch.utils.device import resolve_device, synchronize

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--device", default="cuda")
    p.add_argument("--vmapped", action="store_true",
                   help="train the folds at once through the fold-parallel driver")
    p.add_argument("--out", default=None,
                   help="JSON output (default chiprun_out/torch_cv_protocol[_vmapped].json)")
    args = p.parse_args(argv)
    args.out = args.out or os.path.join(
        ROOT, "chiprun_out", f"torch_cv_protocol{'_vmapped' if args.vmapped else ''}.json")

    dev = resolve_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
    data = make_synthetic(n_windows=WINDOWS, num_classes=CLASSES, sensor_dim=4,
                          windows_per_video=16, noise=NOISE, seed=0)
    data = flip_labels(data, LABEL_FLIP, seed=1)
    folds = kfold_indices(data.videos, n_folds=args.folds, seed=42, by_video=True)
    cfg = load_config(preset_path("gstcan_urfall_3stream"),
                      overrides={"seed": 0, "data.num_classes": CLASSES,
                                 "train.batch_size": 32})
    rows = []
    if args.vmapped:
        synchronize(dev)
        t0 = time.perf_counter()
        res = cross_validate_vmapped(cfg.replace(seed=42), data, n_folds=args.folds,
                                     epochs=args.epochs, device=dev)
        synchronize(dev)
        seconds = (time.perf_counter() - t0) / args.folds
        for fold, r in zip(folds, res["folds"]):
            rows.append({"fold": r["fold"], "train_windows": len(fold["train"]),
                         "valid_windows": len(fold["valid"]),
                         "best_val_accuracy": r["val_accuracy"],
                         "test_accuracy": r["test_accuracy"], "macro_f1": r["macro_f1"],
                         "seconds": seconds})
            print(json.dumps(rows[-1]), flush=True)
    for i, fold in enumerate([] if args.vmapped else folds):
        train, valid = data.subset(fold["train"]), data.subset(fold["valid"])
        splits = {"train": to_device(train, dev), "valid": to_device(valid, dev),
                  "test": to_device(valid, dev)}
        synchronize(dev)
        t0 = time.perf_counter()
        result = run_fold(cfg, splits, epochs=args.epochs, fold_seed=i, device=dev)
        synchronize(dev)
        rows.append({"fold": i, "train_windows": len(train), "valid_windows": len(valid),
                     "best_val_accuracy": result.best_val_accuracy,
                     "test_accuracy": float(result.test.stats["accuracy"]),
                     "macro_f1": float(result.test.stats["macro_f1"]),
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)

    def agg(key):
        vals = [r[key] for r in rows]
        return {"mean": float(np.mean(vals)), "std": float(np.std(vals)), "per_fold": vals}

    acc = agg("best_val_accuracy")
    summary = {
        "driver": "cross_validate_vmapped" if args.vmapped else "run_fold per fold",
        "protocol": {"folds": args.folds, "epochs": args.epochs, "windows": WINDOWS,
                     "classes": CLASSES, "noise": NOISE,
                     "label_flip": LABEL_FLIP, "batch": 32, "fold_seed": 42,
                     "split": "video-level k-fold, valid == test"},
        "device": str(dev), "card": card,
        "best_val_accuracy": acc, "macro_f1": agg("macro_f1"), "seconds": agg("seconds"),
        "jax_run": JAX_RUN,
        # JAX_RUN is the full protocol's; a shorter run is not held against it.
        "within_band": (abs(acc["mean"] - JAX_RUN["mean"]) <= BAND
                        if (args.folds, args.epochs) == (5, 25) else None),
        "rows": rows,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(summary, fh, indent=2)
    print(f"CV best-val accuracy {acc['mean']:.4f} +- {acc['std']:.4f} "
          f"(JAX run {JAX_RUN['mean']} +- {JAX_RUN['std']}; within +-{BAND}: "
          f"{summary['within_band']}), macro F1 {summary['macro_f1']['mean']:.4f} +- "
          f"{summary['macro_f1']['std']:.4f}, {summary['seconds']['mean']:.2f} s a fold "
          f"[{card}]")
    print(json.dumps({k: summary[k] for k in ("best_val_accuracy", "macro_f1", "seconds",
                                              "within_band", "card")}))
    return summary


if __name__ == "__main__":
    main()
