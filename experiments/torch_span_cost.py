"""What the port's span helper (``utils/profiling.py:span``) costs on the
host, with no profiler running and with one running, and what the spans
and the call counter add to one serving call (five spans a batch-128
call).

    python3 experiments/torch_span_cost.py

Prints one JSON line: ns per ``with span(...)`` block, off and on, against
an empty loop body; the host-speed loop the benchmark logs (the same
pure-Python loop, for comparing hosts); the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import timeit

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from fall_multimodal_tpu_torch.serve import Predictor  # noqa: E402
from fall_multimodal_tpu_torch.utils.profiling import span  # noqa: E402

N, REPEAT = 200_000, 7


def per_call_ns(stmt) -> float:
    return 1e9 * min(timeit.repeat(stmt, number=N, repeat=REPEAT)) / N


def spanned():
    with span("predict.prep"):
        pass


def empty():
    pass


def counted():
    Predictor.calls += 1


def host_speed_ms(n: int = 300_000) -> float:
    t = timeit.default_timer()
    s = 0
    for i in range(n):
        s += i * i
    return 1e3 * (timeit.default_timer() - t)


def main() -> None:
    assert not torch.autograd._profiler_enabled()
    out = {"empty_call_ns": per_call_ns(empty), "span_off_ns": per_call_ns(spanned),
           "counter_ns": per_call_ns(counted)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_on_ns"] = 1e9 * min(timeit.repeat(spanned, number=20_000, repeat=3)) / 20_000
    out["serve_call_added_us"] = (5 * out["span_off_ns"] + out["counter_ns"]) / 1e3
    out["host_speed_ms"] = host_speed_ms()
    try:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        out["card"] = None
    print(json.dumps({"span_cost": out}), flush=True)


if __name__ == "__main__":
    main()
