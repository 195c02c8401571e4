"""Where the port's spans put a traced benchmark run's time: for each chrome
trace under ``port_bench/runs/`` (what ``port_bench/run.py --trace 1``
leaves), one JSON line with the traced window, the device's busy time, the
share of busy time launched from inside a port span, the share of idle
time in gaps whose innermost span is a port span, the device seconds by
the port span that launched them, and the idle seconds split by the
innermost port span over each part of each gap.

    python3 experiments/trace_spans.py [root of a checkout]
"""

from __future__ import annotations

import glob
import json
import os
import sys


def main(root: str = ".") -> None:
    sys.path.insert(0, os.path.abspath(root))
    from port_bench.harness import spans
    from port_bench.harness import trace as tr

    for path in sorted(glob.glob(os.path.join(root, "port_bench", "runs", "*", "trace.json"))):
        t = tr.parse_chrome_trace(path, ("trace_start", "trace_stop"))
        d = spans.launched(t, path)
        device = {}
        for name, s, e in zip(d.names, d.start, d.end):
            device[name] = device.get(name, 0.0) + float(e - s)
        idle = spans.idle_by_phase(t)
        print(json.dumps({
            "trace": os.path.relpath(path, root), "window_s": t.window_s, "busy_s": t.busy_s(),
            "busy_in_port_spans": spans.busy_in_port_spans(t, path),
            "idle_in_port_spans": spans.idle_in_port_spans(t),
            "device_s_by_span": dict(sorted(device.items(), key=lambda x: -x[1])),
            "idle_s_by_span": dict(sorted(idle.items(), key=lambda x: -x[1]))}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
