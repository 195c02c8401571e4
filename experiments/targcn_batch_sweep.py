"""Batch sweep of TARGCN serving through the benchmark's cell
``targcn-serve-b8192``: the same cell run with its traffic's batch set to
each of ``--batches``, each at its own seed, once untraced and once traced.
One JSON line a batch: windows/s (untraced), the traced busy share and
per-layer metrics (the device time a call launched in the recurrence and in
the transformer among them), the memory peak, the top device operations and
``correct`` of both runs.

    python3 experiments/targcn_batch_sweep.py --batches 128,1024,4096,8192,16384 --seconds 10

Needs a CUDA card (the cell's run refuses the CPU unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import run  # noqa: E402

CELL = "targcn-serve-b8192"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="experiments/targcn_batch_sweep.py")
    p.add_argument("--batches", default="128,1024,4096,8192,16384")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=3_100_000_000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for i, batch in enumerate(int(b) for b in args.batches.split(",")):
        plain, result = (run.execute(CELL, args.seed + i, args.seconds, trace, device=args.device,
                                     overrides={"traffic": {"batch": batch}})
                         for trace in (False, True))
        dev, metrics = result["device"], {**plain["metrics"], **result["metrics"]}
        row = {"batch": batch, "seed": args.seed + i,
               "correct": plain["correct"] and result["correct"],
               "card": dev["kind"], "memory_peak_bytes": dev["memory_peak_bytes"],
               "busy_share": dev.get("busy_s", 0.0) / dev["window_s"] if dev.get("window_s")
               else None,
               **{k: v["value"] for k, v in metrics.items()},
               "logit_gap": result["checks"]["logit_gap"]["value"],
               "top_device_ops": result.get("breakdown", {}).get("device_ops", [])[:6]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
