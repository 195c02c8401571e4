"""Device time launched from inside the system's spans of any name, however
deeply they nest in the phases ``harness/spans.py`` names.

``spans.device_ms`` gives each device activity to the innermost of the
phase spans it knows (``spans.PORT_SPANS``) open at its launch; a span
inside a phase, such as the ``targcn.recurrence`` ranges a TARGCN forward
records inside ``predict.launch``, is not among them. Here an activity
counts for a name where its launching call (linked by the trace's
``correlation`` argument) started inside a span of that name, on any
thread. The chrome trace is the one ``spans.trace_file`` finds for the
run's traced window.

A program without such spans or counters (one older than them) gives
nothing to read: the reader then returns None.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
from typing import Optional, Tuple

import numpy as np

from port_bench.harness import spans
from port_bench.harness.trace import DEVICE_CATEGORIES, clip, covered, union


@functools.lru_cache(maxsize=2)
def _activities(path: str, mtime: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(start, end, launched)`` in seconds of every device activity in the
    chrome trace at ``path``, ``launched`` the start of its launching call
    (NaN where none is linked). ``mtime`` keys the cache to the file's
    contents."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = [ev for ev in json.load(fh)["traceEvents"] if ev.get("ph") == "X"]
    launch = {int(ev["args"]["correlation"]): ev["ts"] * 1e-6 for ev in events
              if ev.get("cat") in spans.LAUNCH_CATEGORIES
              and ev.get("args", {}).get("correlation") is not None}
    rows = []
    for ev in events:
        if ev.get("cat") in DEVICE_CATEGORIES:
            corr = ev.get("args", {}).get("correlation")
            rows.append((ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6,
                         launch.get(int(corr), np.nan) if corr is not None else np.nan))
    a = np.asarray(rows, float).reshape(-1, 3)
    return a[:, 0], a[:, 1], a[:, 2]


def device_ms_within(run, name: str, per: Optional[int] = None) -> Optional[float]:
    """Device milliseconds (union of intervals, inside the traced window)
    launched from inside ``name`` spans, over ``per`` (a counter's delta)
    or over the number of those spans in the window; None without a trace,
    its file, such a span, such device time or a count."""
    trace = run.trace
    if trace is None:
        return None
    sp = trace.spans.named(name)
    s, e = union(*clip(sp.start, sp.end, *trace.window))
    n = len(clip(sp.start, sp.end, *trace.window)[0]) if per is None else per
    if not len(s) or n <= 0:
        return None
    path = spans.trace_file(trace, run.cell.name)
    if path is None:
        return None
    start, end, launched = _activities(path, os.path.getmtime(path))
    at = np.searchsorted(s, launched, side="right") - 1
    inside = np.isfinite(launched) & (at >= 0)
    inside[inside] = launched[inside] <= e[at[inside]]
    seconds = covered(start[inside], end[inside], *trace.window)
    return 1e3 * seconds / n if seconds > 0 else None
