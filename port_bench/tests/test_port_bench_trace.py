"""The trace arithmetic on synthetic intervals: busy time is the union of
the device's intervals (a copy that overlaps a kernel counts once), idle
shares over the window and inside spans, idle gaps labelled by the span
open at them, device activities per step, and the chrome-trace reader."""

import json

import numpy as np
import pytest

from port_bench.harness import trace as tr


def _trace(device, spans, window):
    return tr.Trace(tr.Intervals.of(device), tr.Intervals.of(spans), window)


def test_union_merges_overlaps_and_touching():
    s, e = tr.union(np.array([0.0, 1.0, 1.5, 5.0, 2.0]), np.array([2.0, 1.2, 3.0, 6.0, 2.5]))
    assert s.tolist() == [0.0, 5.0] and e.tolist() == [3.0, 6.0]


def test_a_copy_overlapping_a_kernel_counts_once():
    t = _trace([("kernel", 1.0, 3.0), ("Memcpy HtoD", 2.0, 4.0), ("kernel", 6.0, 7.0)],
               [], (0.0, 10.0))
    assert t.busy_s() == pytest.approx(4.0)          # not 2 + 2 + 1 = 5
    assert t.idle_share() == pytest.approx(0.6)


def test_busy_time_is_clipped_to_the_window():
    t = _trace([("kernel", -1.0, 1.0), ("kernel", 9.0, 12.0)], [], (0.0, 10.0))
    assert t.busy_s() == pytest.approx(2.0)
    assert len(t.device_in_window()) == 0


def test_idle_inside_spans_leaves_out_the_time_between_them():
    device = [("k", 1.0, 1.5), ("k", 5.0, 5.2), ("copy", 5.1, 5.4)]
    spans = [("push", 1.0, 2.0), ("wait", 2.0, 5.0), ("push", 5.0, 6.0)]
    t = _trace(device, spans, (0.0, 10.0))
    # pushes cover 2.0 s; the device runs 0.5 + 0.4 of it
    assert t.idle_share_inside("push") == pytest.approx(1 - 0.9 / 2.0)
    assert t.idle_share_inside("absent") is None


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    device = [("k", 1.0, 2.0), ("k", 4.0, 5.0)]
    spans = [("epoch", 0.0, 10.0), ("checkpoint", 2.0, 4.0)]
    t = _trace(device, spans, (0.0, 6.0))
    gaps = dict(t.idle_by_span(default="host"))
    assert gaps["checkpoint (1 gaps)"] == pytest.approx(2.0)
    assert gaps["epoch (2 gaps)"] == pytest.approx(2.0)       # [0, 1] and [5, 6]
    t2 = _trace(device, [], (0.0, 6.0))
    assert dict(t2.idle_by_span(default="host")) == {"host (3 gaps)": pytest.approx(4.0)}


def test_top_device_ops_sum_by_name():
    t = _trace([("a", 0.0, 1.0), ("b", 1.0, 3.0), ("a", 3.0, 4.5)], [], (0.0, 5.0))
    assert t.top_device_ops() == [["a", pytest.approx(2.5)], ["b", pytest.approx(2.0)]]


def test_device_ops_per_step():
    t = _trace([("k", i, i + 0.5) for i in range(10)], [], (0.0, 20.0))
    assert tr.device_ops_per_step(t, 4) == pytest.approx(2.5)
    assert tr.device_ops_per_step(t, 0) is None


def test_chrome_trace_reader(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "trace_start", "ts": 100.0, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": "predict", "ts": 110.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "stgcan_block_kernel", "ts": 120.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 130.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "predict", "ts": 115.0, "dur": 40.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 111.0, "dur": 2.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 111.0},
        {"ph": "X", "cat": "user_annotation", "name": "trace_stop", "ts": 199.0, "dur": 1.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = tr.parse_chrome_trace(str(path), ("trace_start", "trace_stop"))
    assert t.window == pytest.approx((100e-6, 200e-6))
    assert t.device.names == ["stgcan_block_kernel", "Memcpy DtoH"]   # no GPU annotations
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.idle_share() == pytest.approx(0.7)
    assert t.spans.named("predict").start.tolist() == pytest.approx([110e-6])
