"""Benchmark of the PyTorch/CUDA fall-detection system
(``fall_multimodal_tpu_torch``) on one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. One call runs the cell once: it makes the
inputs and the weights from ``--seed``, sets up the system and warms up the
shapes the cell's traffic uses, measures for ``--seconds`` seconds, holds
what the window produced against the plain reference, and prints one JSON
line as the last line of standard output. With ``--trace 1`` it traces
part of the window with ``torch.profiler`` and prints the cell's per-layer
metrics; the chrome trace is left under ``port_bench/runs/``. It needs a
CUDA card and refuses to run on the CPU.
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

from port_bench.harness import core  # noqa: E402


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            root: str = ROOT, overrides=None, t_process: float = T_PROCESS) -> dict:
    """One run of one cell; returns the result line as a dict (the numbers
    compared under ``checks``, last)."""
    import torch

    from port_bench.harness import costs, generators
    from port_bench.harness.trace import Tracer

    cell = core.load_cell(root, workload, trace, overrides)
    torch.set_num_threads(2)
    dev = torch.device(device)
    out_dir = os.path.join(root, "port_bench", "runs", f"{workload}.{seed}")
    ctx = core.Ctx(cell, seed, seconds, dev, Tracer(trace, out_dir), t_process)
    ctx.mark("imports")
    outcome = generators.GENERATORS[cell.traffic["generator"]](ctx)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for note in outcome.notes + [ctx.stages_note()]:
        core.log(note)
    core.log(f"card before the window: {ctx.card_before}")
    core.log(f"card after the window: {ctx.card_after}")
    core.log(f"host over the window: {ctx.host_note()}")

    tr = ctx.tracer.trace
    run = core.Run(cell, name, ctx.setup_s, outcome.host, tr, ctx.counter_deltas,
                   costs.peaks(name))
    metrics = {}
    for metric, entry in cell.metrics.items():
        value = cell.readers[metric].read(run)
        if value is not None:
            metrics[metric] = {"value": float(value), "unit": entry["unit"]}
    checks, correct = {}, outcome.failed == 0 and outcome.attempted > 0
    for number, value in outcome.checks.items():
        limit = cell.limits[number]["limit"]
        checks[number] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    result = {"correct": bool(correct), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                         "count": torch.cuda.device_count() if dev.type == "cuda" else 0,
                         "memory_peak_bytes": outcome.memory_peak_bytes}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(10),
                               "idle_gaps": tr.idle_by_span(
                                   10, cell.traffic.get("host_label", "outside any span"))}
    result["checks"] = checks
    for number, c in checks.items():
        core.log(f"check {number}: {c['value']!r} against the limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="port_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        chips = next((int(w["chips"]) for w in json.load(fh)["workloads"]
                      if w["name"] == args.workload), None)
    if chips is None:
        core.log(f"BENCHMARK.json has no workload {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"the cell {args.workload!r} needs {chips} CUDA card(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in core.BANNED_MODULES)
    if loaded:
        core.log(f"the process loaded modules it must not: {loaded}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
