"""Where a traced ``musa-train-b256`` run spends the card's time: from the
chrome trace that ``port_bench/run.py --trace 1`` leaves, one JSON line
with the traced window, the device's busy time, the device seconds and
kernel launches by the innermost span whose host range holds each
activity's launch (musa's ``musa.graph`` / ``musa.temporal`` /
``musa.dropgraph`` inside ``step.forward``, then the phase spans), the ten
busiest kernels of each musa span and of ``step.backward``, and the idle
seconds by the innermost span open over each gap.

    python3 experiments/musa_trace_breakdown.py port_bench/runs/musa-train-b256.<seed>/trace.json
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

import numpy as np

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")


def innermost(starts, ends, names, at):
    """Name of the shortest span holding each time in ``at`` ("" if none)."""
    out = []
    for x in at:
        inside = np.flatnonzero((starts <= x) & (ends >= x))
        out.append(names[inside[np.argmin(ends[inside] - starts[inside])]] if len(inside) else "")
    return out


def main(path: str) -> None:
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("cat") == "user_annotation"]
    lo = min(s for n, s, _ in spans if n == "trace_start")
    hi = max(e for n, _, e in spans if n == "trace_stop")
    keep = [s for s in spans if s[0].startswith(("musa.", "step.", "fit.", "checkpoint."))
            or s[0] == "train.step"]
    names = [s[0] for s in keep]
    starts = np.array([s[1] for s in keep])
    ends = np.array([s[2] for s in keep])
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH and "correlation" in e.get("args", {})}
    acts = [e for e in events if e.get("cat") in DEVICE and lo <= e["ts"] <= hi]
    owner = innermost(starts, ends, names,
                      [launch.get(e.get("args", {}).get("correlation"), -1.0) for e in acts])
    by_span, count = defaultdict(float), defaultdict(int)
    kernels = defaultdict(lambda: defaultdict(float))
    for e, who in zip(acts, owner):
        by_span[who or "outside any span"] += e.get("dur", 0) * 1e-6
        count[who or "outside any span"] += 1
        kernels[who][e["name"][:90]] += e.get("dur", 0) * 1e-6
    order = np.argsort([e["ts"] for e in acts])
    s = np.array([acts[i]["ts"] for i in order])
    e = np.array([acts[i]["ts"] + acts[i].get("dur", 0) for i in order])
    reach = np.maximum.accumulate(e) if len(e) else e
    gap_s = np.concatenate([[lo], reach[:-1]]) if len(e) else np.array([lo])
    gap_e = s if len(e) else np.array([hi])
    idle = defaultdict(float)
    mids = (gap_s + gap_e) / 2
    for who, a, b in zip(innermost(starts, ends, names, mids), gap_s, gap_e):
        if b > a:
            idle[who or "outside any span"] += (b - a) * 1e-6
    busy = float(sum(max(0.0, b - max(a, r)) for a, b, r in
                     zip(s, e, np.concatenate([[lo], reach[:-1]])))) * 1e-6 if len(e) else 0.0
    steps = names.count("train.step")
    top = {k: dict(sorted(((n, round(v, 5)) for n, v in kernels[k].items()),
                          key=lambda x: -x[1])[:10])
           for k in ("musa.graph", "musa.temporal", "musa.dropgraph", "step.backward")}
    print(json.dumps({
        "trace": path, "window_s": (hi - lo) * 1e-6, "busy_s": busy, "train_steps": steps,
        "device_s_by_span": dict(sorted(by_span.items(), key=lambda x: -x[1])),
        "activities_by_span": dict(sorted(count.items(), key=lambda x: -x[1])),
        "activities_per_step": {k: v / max(steps, 1) for k, v in count.items()
                                if k.startswith(("musa.", "step."))},
        "top_kernels": top,
        "idle_s_by_span": dict(sorted(idle.items(), key=lambda x: -x[1]))}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
