"""Readings that set the limits of ``correct``: the system's numbers, the
control's and the planted faults', one cell at its own size, on several
seeds, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,13

The control is the plain reference computed with TF32 switched on (the
nearest precision below the float32 the configurations state), put in the
system's place. The faults, planted in the system's answers or in the
reference put in its place: an answer altered where it is produced (one
logit moved by one), half of a batch left out (serving: the first half's
answers given for the second; training: the loss the mean over the first
half of the rows), and for training a state left unchanged (reads 1 by
construction). Each seed prints one JSON line; the lines also go to
``<out>/calibrate.<cell>.jsonl`` (``--out``, by default ``port_bench/runs``).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench.harness import checks, core, generators  # noqa: E402
from port_bench.harness.trace import Tracer  # noqa: E402


def altered(answers):
    out = [a.copy() for a in answers] if isinstance(answers, list) else answers.copy()
    first = out[0] if isinstance(out, list) else out
    first[0, 0] += 1.0
    return out


def serve_readings(ctx) -> dict:
    job = generators.ClosedBatches(ctx)
    answers = [job.predictor.predict_logits(job.pose[i], job._sensor(i)) for i in range(job.pool)]
    job.answers = answers
    job.free_program()
    ref = job.reference()
    control = job.reference(tf32=True)
    half = [np.concatenate([a[:len(a) // 2], a[:len(a) - len(a) // 2]]) for a in answers]
    return {"program": job.compare(answers, ref)["logit_gap"],
            "control": checks.logit_gap(control.reshape(-1, control.shape[-1]),
                                        ref.reshape(-1, ref.shape[-1])),
            "fault.altered": job.compare(altered(answers), ref)["logit_gap"],
            "fault.half": job.compare(half, ref)["logit_gap"]}


def train_readings(ctx) -> dict:
    job = generators.TrainJob(ctx)
    job.free_program()
    ref = job.reference()
    soft = ctx.config["train"]["softmax_output"]

    def ce(logits, target):
        if soft:
            logits = torch.softmax(logits, -1)
        return -(target * torch.log_softmax(logits, -1)).sum(-1)

    def half(logits, target):
        n = len(logits) // 2
        return ce(logits[:n], target[:n]).mean()

    def alter(logits, target):
        bump = torch.zeros_like(logits)
        bump[0, 0] = 1.0
        return ce(logits + bump, target).mean()

    out = {"program": job.compare(job.program, ref),
           "control": job.compare(job.reference(tf32=True), ref),
           "fault.half": job.compare(job.reference(loss_fn=half), ref),
           "fault.altered": job.compare(job.reference(loss_fn=alter), ref)}
    keep = [n for n in ref["change"] if n not in checks.quiet_leaves(ref["grad"])]
    double = job.reference(dtype=torch.float64)
    out["reference_in_float64"] = job.compare(double, ref)
    for name, side in (("program", job.program), ("control", job.reference(tf32=True))):
        gaps = [abs(side["change"][n] - ref["change"][n]) / ref["change"][n] for n in keep]
        out[name]["readings"]["change_gap_median_leaf"] = float(np.median(gaps))
    return out


READINGS = {"closed_batches": serve_readings, "train_job": train_readings}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="port_bench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(ROOT, "port_bench", "runs"))
    args = p.parse_args(argv)
    torch.set_num_threads(2)
    cell = core.load_cell(ROOT, args.workload, False)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"calibrate.{args.workload}.jsonl")
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    with open(path, "a") as fh:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            ctx = core.Ctx(cell, seed, 0.0, torch.device(args.device),
                           Tracer(False, ""), t0)
            row = {"workload": args.workload, "seed": seed, "card": name,
                   **READINGS[cell.traffic["generator"]](ctx), "seconds": time.perf_counter() - t0}
            line = json.dumps(row)
            print(line, flush=True)
            fh.write(line + "\n")
            generators.free_device(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
