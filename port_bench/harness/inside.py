"""Spans of one name taken only where they start inside a phase span.

A model's spans (``musa.temporal``) open in every forward of a run: in the
train steps and in the eval passes of ``fit``. A per-step metric of the
train forward takes the ones that start inside ``step.forward``; the run it
then reads (``nested.device_ms_within``) holds only those.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from port_bench.harness.trace import Intervals, union


def only_inside(run, name: str, phase: str):
    """``run`` with its trace's ``name`` spans cut to those whose start lies
    inside a ``phase`` span (the other spans as they were); ``run`` itself
    where it has no trace."""
    trace = run.trace
    if trace is None:
        return run
    sp, ph = trace.spans, trace.spans.named(phase)
    ps, pe = union(ph.start, ph.end)
    at = np.searchsorted(ps, sp.start, side="right") - 1
    within = at >= 0
    within[within] = sp.start[within] <= pe[at[within]]
    keep = [i for i, n in enumerate(sp.names) if n != name or within[i]]
    spans = Intervals([sp.names[i] for i in keep], sp.start[keep], sp.end[keep])
    return dataclasses.replace(run, trace=trace._replace(spans=spans))
