"""Device traces and the benchmark's spans: recording with ``torch.profiler``
and the arithmetic per-layer metrics read from it.

Busy time is the union of the device's intervals (kernels, copies, sets):
a copy that overlaps a kernel counts once. Spans are the benchmark's own
annotations around its calls into the system (``torch.profiler.
record_function``), so they share the trace's clock.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CATEGORY = "user_annotation"


class Intervals(NamedTuple):
    """Named intervals in seconds, sorted by start."""

    names: List[str]
    start: np.ndarray
    end: np.ndarray

    @classmethod
    def of(cls, rows: Iterable[Tuple[str, float, float]]) -> "Intervals":
        rows = sorted(rows, key=lambda r: r[1])
        return cls([r[0] for r in rows], np.asarray([r[1] for r in rows], float),
                   np.asarray([r[2] for r in rows], float))

    def named(self, name: str) -> "Intervals":
        keep = [i for i, n in enumerate(self.names) if n == name]
        return Intervals([self.names[i] for i in keep], self.start[keep], self.end[keep])

    def __len__(self) -> int:
        return len(self.names)


def union(start: np.ndarray, end: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The union of intervals as disjoint sorted ``(start, end)`` arrays."""
    if len(start) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(start, kind="stable")
    s, e = np.asarray(start, float)[order], np.asarray(end, float)[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def clip(start: np.ndarray, end: np.ndarray, lo: float, hi: float) -> Tuple[np.ndarray, np.ndarray]:
    s, e = np.maximum(start, lo), np.minimum(end, hi)
    keep = e > s
    return s[keep], e[keep]


def covered(start, end, lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the union of the intervals covers."""
    s, e = clip(*union(start, end), lo, hi)
    return float((e - s).sum())


def overlap(a: Tuple[np.ndarray, np.ndarray], b: Tuple[np.ndarray, np.ndarray]) -> float:
    """Length of the intersection of two unions, each ``(start, end)``."""
    (sa, ea), (sb, eb) = union(*a), union(*b)
    total, j = 0.0, 0
    for s, e in zip(sa, ea):
        while j < len(sb) and eb[j] <= s:
            j += 1
        k = j
        while k < len(sb) and sb[k] < e:
            total += min(e, eb[k]) - max(s, sb[k])
            k += 1
    return total


def gaps(start, end, lo: float, hi: float) -> Tuple[np.ndarray, np.ndarray]:
    """The idle gaps of ``[lo, hi]``: where no interval lies."""
    s, e = clip(*union(start, end), lo, hi)
    gs = np.concatenate([[lo], e])
    ge = np.concatenate([s, [hi]])
    keep = ge > gs
    return gs[keep], ge[keep]


def innermost(spans: Intervals, at: np.ndarray, default: str = "outside any span") -> List[str]:
    """For each time in ``at``, the name of the shortest span that holds it."""
    out = []
    for x in at:
        inside = np.flatnonzero((spans.start <= x) & (spans.end >= x))
        if len(inside) == 0:
            out.append(default)
        else:
            i = inside[np.argmin(spans.end[inside] - spans.start[inside])]
            out.append(spans.names[i])
    return out


class Trace(NamedTuple):
    """A parsed profiler trace: device activities, the benchmark's spans and
    marks, and the traced window ``(lo, hi)``, all in seconds."""

    device: Intervals
    spans: Intervals
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return covered(self.device.start, self.device.end, *self.window)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def device_in_window(self) -> Intervals:
        lo, hi = self.window
        keep = [i for i in range(len(self.device))
                if self.device.start[i] >= lo and self.device.end[i] <= hi]
        d = self.device
        return Intervals([d.names[i] for i in keep], d.start[keep], d.end[keep])

    def idle_share_inside(self, span_name: str) -> Optional[float]:
        """The share of the time inside ``span_name`` spans in which the device
        ran nothing; None if there is no such span."""
        sp = self.spans.named(span_name)
        lo, hi = self.window
        s, e = clip(*union(sp.start, sp.end), lo, hi)
        inside = float((e - s).sum())
        if inside <= 0:
            return None
        return 1.0 - overlap((self.device.start, self.device.end), (s, e)) / inside

    def top_device_ops(self, k: int = 10) -> List[List]:
        d = self.device_in_window()
        totals: Dict[str, float] = {}
        for name, s, e in zip(d.names, d.start, d.end):
            totals[name] = totals.get(name, 0.0) + (e - s)
        return [[n[:120], t] for n, t in sorted(totals.items(), key=lambda x: -x[1])[:k]]

    def idle_by_span(self, k: int = 10, default: str = "outside any span") -> List[List]:
        """Idle time of the window summed by the benchmark span open at each
        gap's middle (``default`` where none is), the spans with the most
        first."""
        gs, ge = gaps(self.device.start, self.device.end, *self.window)
        labels = innermost(self.spans, (gs + ge) / 2, default)
        totals: Dict[str, List[float]] = {}
        for name, d in zip(labels, ge - gs):
            acc = totals.setdefault(name, [0.0, 0])
            acc[0] += d
            acc[1] += 1
        ranked = sorted(totals.items(), key=lambda x: -x[1][0])[:k]
        return [[f"{name} ({int(n)} gaps)", t] for name, (t, n) in ranked]


def parse_chrome_trace(path: str, window_marks: Tuple[str, str]) -> Trace:
    """Read a chrome trace ``torch.profiler`` exported. The window runs from
    the start of the first ``window_marks[0]`` annotation to the end of the
    last ``window_marks[1]`` annotation."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        row = (ev.get("name", ""), ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6)
        if cat in DEVICE_CATEGORIES:
            device.append(row)
        elif cat == SPAN_CATEGORY:
            spans.append(row)
    spans_iv = Intervals.of(spans)
    first, last = spans_iv.named(window_marks[0]), spans_iv.named(window_marks[1])
    if not len(first) or not len(last):
        raise RuntimeError(f"the trace {path} holds no {window_marks} annotations")
    return Trace(Intervals.of(device), spans_iv, (float(first.start[0]), float(last.end[-1])))


class Tracer:
    """Spans and marks around the benchmark's calls, recorded only while a
    profiler runs; :meth:`start` and :meth:`stop` bound the traced part of
    the window, and :meth:`stop` writes and parses the chrome trace."""

    def __init__(self, enabled: bool, out_dir: str):
        self.enabled, self.out_dir = enabled, out_dir
        self.active = False
        self.prof = None
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def mark(self, name: str) -> None:
        with self.span(name):
            pass

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def prime(self) -> None:
        """Profile one small device operation, so that the profiler's own
        start-up (CUPTI's, on the card) falls in set-up and not in the
        traced part of the window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            x = torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu")
            (x + x).sum().item()

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import profile

        self.prof = profile(activities=self._activities())
        self.prof.start()
        self.active = True
        self.mark("trace_start")

    def stop(self) -> None:
        if not self.active:
            return
        import torch

        self.mark("trace_stop")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.active = False
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.trace = parse_chrome_trace(path, ("trace_start", "trace_stop"))


def device_ops_per_step(trace: Trace, steps: int) -> Optional[float]:
    """Device activities (kernels, copies, sets) in the window per step."""
    if steps <= 0:
        return None
    return len(trace.device_in_window()) / steps
