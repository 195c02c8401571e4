"""The system's own spans and counters in a traced run, and the arithmetic
the per-layer metrics of its phases read from them.

The port names the phases of a serving call, an epoch, a train step and a
checkpoint with ``torch.profiler.record_function`` ranges (:data:`PORT_SPANS`)
while a profiler runs; they land in the chrome trace as ``user_annotation``
events beside the benchmark's own spans, on the clock of the card's
activities. Two counters of the system give the denominators: its
``predict_logits`` calls and its train steps.

A phase's host time is the length of its spans in the traced window. A
phase's device time is the union of the device activities (kernels, copies,
sets) launched from inside it: each activity is linked by the trace's
``correlation`` argument to the ``cuda_runtime`` (or ``cuda_driver``) call
that launched it, and takes the innermost port span open at that call's
start, on any thread (autograd launches the backward from a thread of its
own while the caller waits inside ``step.backward``).

The correlation ids are not kept on the parsed :class:`Trace`, so the
device-time readers read its chrome trace again: the newest file under
:data:`RUNS` (where ``port_bench/run.py`` leaves a cell's traced run, as
``<cell>.<seed>/trace.json``) whose traced window is the trace's own.

A program without these spans or counters (one older than them) gives
nothing to read: the readers then return None.
"""

from __future__ import annotations

import functools
import glob
import gzip
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from port_bench.harness import core
from port_bench.harness.trace import (DEVICE_CATEGORIES, SPAN_CATEGORY, Intervals, Trace,
                                      clip, covered, gaps, innermost, overlap, union)

PORT_SPANS = frozenset({
    "predict_logits", "predict.prep", "predict.h2d", "predict.launch", "predict.d2h",
    "fit.epoch", "fit.shuffle", "fit.train", "fit.eval", "fit.read", "fit.snapshot", "fit.chunk",
    "train.step", "step.gather", "step.forward", "step.backward", "step.optimizer",
    "checkpoint.save", "checkpoint.serialize", "checkpoint.swap",
})
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
WINDOW_MARKS = ("trace_start", "trace_stop")
RUNS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runs")
PREDICT_CALLS = "fall_multimodal_tpu_torch.serve:Predictor.calls"
TRAIN_STEPS = "fall_multimodal_tpu_torch.train.loop:make_train_step.steps"


def present(counters: Dict[str, str]) -> Dict[str, str]:
    """The entries of ``{key: "module:attr.attr"}`` whose counter the system
    has, so that a reader can name a counter an older program lacks."""
    out = {}
    for key, spec in counters.items():
        try:
            core.read_counter(spec)
        except (ImportError, AttributeError):
            continue
        out[key] = spec
    return out


def _in_window(trace: Trace, name: str) -> Tuple[np.ndarray, np.ndarray]:
    sp = trace.spans.named(name)
    return clip(sp.start, sp.end, *trace.window)


def span_ms(trace: Optional[Trace], name: str, per: Optional[int] = None) -> Optional[float]:
    """Milliseconds of host time inside ``name`` spans in the traced window,
    over ``per`` (a counter's delta), or over the number of those spans;
    None without a trace, a span or a count."""
    if trace is None:
        return None
    s, e = _in_window(trace, name)
    n = len(s) if per is None else per
    if not len(s) or n <= 0:
        return None
    return 1e3 * float((e - s).sum()) / n


def idle_inside_share(trace: Optional[Trace], name: str) -> Optional[float]:
    """Percent of the traced window in which the device ran nothing while
    the host was inside a ``name`` span; None without such a span."""
    if trace is None:
        return None
    s, e = union(*_in_window(trace, name))
    if not len(s):
        return None
    idle = float((e - s).sum()) - overlap((trace.device.start, trace.device.end), (s, e))
    return 100.0 * idle / trace.window_s


@functools.lru_cache(maxsize=2)
def _launched(path: str, mtime: float) -> Tuple[Optional[Tuple[float, float]], Intervals]:
    """The traced window of the chrome trace at ``path`` (None without its
    marks), and the device activities inside it, each named by the innermost
    port span open at its launch ("" where none is, or where no launch is
    linked to it). ``mtime`` keys the cache to the file's contents."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = [ev for ev in json.load(fh)["traceEvents"] if ev.get("ph") == "X"]
    launch, spans, marks, rows = {}, [], [], []
    for ev in events:
        cat, corr = ev.get("cat"), ev.get("args", {}).get("correlation")
        if cat in LAUNCH_CATEGORIES and corr is not None:
            launch[int(corr)] = ev["ts"] * 1e-6
        elif cat == SPAN_CATEGORY:
            row = (ev.get("name", ""), ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6)
            if row[0] in PORT_SPANS:
                spans.append(row)
            elif row[0] in WINDOW_MARKS:
                marks.append(row)
    marks_iv = Intervals.of(marks)        # the window as trace.parse_chrome_trace takes it
    first, last = marks_iv.named(WINDOW_MARKS[0]), marks_iv.named(WINDOW_MARKS[1])
    if not len(first) or not len(last):
        return None, Intervals.of([])
    lo, hi = float(first.start[0]), float(last.end[-1])
    for ev in events:
        if ev.get("cat") in DEVICE_CATEGORIES:
            s, e = ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6
            if s >= lo and e <= hi:
                corr = ev.get("args", {}).get("correlation")
                rows.append((s, e, launch.get(int(corr), np.nan) if corr is not None else np.nan))
    rows.sort()
    at = np.array([r[2] for r in rows], float)
    phase = [""] * len(rows)
    linked = np.flatnonzero(np.isfinite(at))
    for i, name in zip(linked, innermost(Intervals.of(spans), at[linked], "")):
        phase[i] = name
    return (lo, hi), Intervals(phase, np.array([r[0] for r in rows], float),
                               np.array([r[1] for r in rows], float))


def _read(path: str) -> Tuple[Optional[Tuple[float, float]], Intervals]:
    return _launched(path, os.path.getmtime(path))


def trace_file(trace: Trace, cell: Optional[str] = None) -> Optional[str]:
    """The chrome trace ``trace`` was parsed from: the newest
    ``<RUNS>/<cell>.<seed>/trace.json`` (of any cell without ``cell``) whose
    traced window is ``trace``'s own; None where there is none."""
    runs = f"{glob.escape(cell)}.*" if cell else "*"
    found = glob.glob(os.path.join(RUNS, runs, "trace.json"))
    for path in sorted(found, key=os.path.getmtime, reverse=True):
        if _read(path)[0] == trace.window:
            return path
    return None


def launched(trace: Trace, path: str) -> Intervals:
    """The window's device activities, read from ``path`` (the chrome trace
    ``trace`` was parsed from), each named by the innermost port span open
    at its launch ("" where none is)."""
    window, acts = _read(path)
    if window != trace.window:
        raise ValueError(f"{path} is not the chrome trace of this window")
    return acts


def device_ms(run, name: str, per: Optional[int] = None) -> Optional[float]:
    """Device milliseconds (union of intervals) launched from inside ``name``
    spans in a run's traced window, over ``per`` (a counter's delta) or over
    the number of those spans; None without a trace, its file, such device
    time or a count."""
    trace = run.trace
    if trace is None:
        return None
    n = len(_in_window(trace, name)[0]) if per is None else per
    path = trace_file(trace, run.cell.name) if n > 0 else None
    if path is None:
        return None
    d = launched(trace, path).named(name)
    seconds = covered(d.start, d.end, *trace.window)
    return 1e3 * seconds / n if seconds > 0 else None


def busy_in_port_spans(trace: Trace, path: str) -> float:
    """Share of the window's busy time launched from inside a port span;
    ``path`` is the chrome trace ``trace`` was parsed from."""
    d = launched(trace, path)
    keep = np.array([n != "" for n in d.names], bool)
    busy = trace.busy_s()
    if busy <= 0 or not len(d):
        return 0.0
    return covered(d.start[keep], d.end[keep], *trace.window) / busy


def idle_in_port_spans(trace: Trace) -> float:
    """Share of the window's idle time in gaps whose innermost span (of all
    spans, at the gap's middle, as the breakdown labels gaps) is a port span."""
    gs, ge = gaps(trace.device.start, trace.device.end, *trace.window)
    if not len(gs):
        return 1.0
    labels = innermost(trace.spans, (gs + ge) / 2, "")
    inside = np.array([n in PORT_SPANS for n in labels], bool)
    return float((ge - gs)[inside].sum() / (ge - gs).sum())


def idle_by_phase(trace: Trace) -> Dict[str, float]:
    """The window's idle seconds split by the innermost port span open over
    each part of each gap ("" where none is): unlike the breakdown, which
    puts a whole gap down to the span open at its middle, a gap that runs
    from one phase into the next is shared between them."""
    sp = Intervals.of([(n, s, e) for n, s, e in zip(trace.spans.names, trace.spans.start,
                                                       trace.spans.end) if n in PORT_SPANS])
    gs, ge = gaps(trace.device.start, trace.device.end, *trace.window)
    cuts = np.unique(np.concatenate([gs, ge, clip(sp.start, sp.end, *trace.window)[0],
                                     clip(sp.start, sp.end, *trace.window)[1]]))
    lo, hi = cuts[:-1], cuts[1:]
    g = np.searchsorted(gs, lo, side="right") - 1
    idle = (g >= 0) & (lo < ge[np.maximum(g, 0)])
    out: Dict[str, float] = {}
    for name, a, b in zip(innermost(sp, (lo[idle] + hi[idle]) / 2, ""), lo[idle], hi[idle]):
        out[name] = out.get(name, 0.0) + float(b - a)
    return out
