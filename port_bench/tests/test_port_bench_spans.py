"""The per-layer metrics that read the system's own spans and counters
(``harness/spans.py``), on a hand-built chrome trace: device activities
linked by ``correlation`` to the runtime calls that launched them inside the
phase spans (the backward's from another thread), host spans of a serving
call, and a checkpoint with the device idle. The metrics the benchmark
had read the same numbers from it as from the same trace without the
system's spans and runtime calls, which is what a program older than them
leaves."""

import json
import os

import pytest

from port_bench.harness import core, costs, spans
from port_bench.harness import trace as tr

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
H100 = "NVIDIA H100 80GB HBM3"
OLD_TRAIN = ("mfu.train", "idle_share.train", "device_ops_per_step.train")
OLD_SERVE = ("k1_roofline.serve", "k2_roofline.serve", "mfu.serve", "idle_share.serve")
NEW_TRAIN = ("gather_ms.train", "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
             "eval_ms.train", "checkpoint_stall.train")
NEW_SERVE = ("prep_ms.serve", "h2d_ms.serve", "launch_ms.serve")


class Events:
    """Chrome-trace events, times in microseconds."""

    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, ts, dur, tid=1):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                            "dur": dur, "tid": tid})

    def launch(self, at, start, dur, name="k", cat="kernel", tid=1):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "ts": at, "dur": 2.0, "tid": tid, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": start, "dur": dur,
                            "args": {"correlation": self.corr}})

    def write(self, path, system=True):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        keep = [e for e in self.events if system or not (
            e["cat"] == "cuda_runtime" or (e["cat"] == "user_annotation"
                                           and e["name"] in spans.PORT_SPANS))]
        with open(path, "w") as fh:
            json.dump({"traceEvents": keep}, fh)
        return tr.parse_chrome_trace(str(path), ("trace_start", "trace_stop"))


def train_events():
    """Two steps and an epoch's eval and checkpoint in a window of 1,000 us.
    Each step: a gather kernel of 5 us, forward 20 us, backward 40 us (from
    thread 2), optimizer 10 us. The eval span runs 100 us; the checkpoint
    saves 200 us, in which the device runs 30 us of copies. The eval pass
    launches a kernel of 60 us."""
    ev = Events()
    ev.span("trace_start", 0.0, 1.0)
    ev.span("fit.epoch", 2.0, 990.0)
    ev.span("fit.train", 3.0, 300.0)
    for i, t in enumerate((10.0, 160.0)):
        ev.span("train.step", t, 140.0)
        ev.span("step.gather", t + 1, 5.0)
        ev.launch(t + 2, t + 10, 5.0, "index_select")
        ev.span("step.forward", t + 10, 20.0)
        ev.launch(t + 11, t + 20, 20.0, "fprop")
        ev.span("step.backward", t + 35, 50.0)
        ev.span("Optimizer.zero_grad#RMSprop.zero_grad", t + 36, 1.0)
        ev.launch(t + 40, t + 45, 40.0, "dgrad", tid=2)
        ev.span("step.optimizer", t + 90, 40.0)
        ev.span("Optimizer.step#RMSprop.step", t + 91, 30.0)
        ev.launch(t + 92, t + 95, 10.0, "rmsprop")
    ev.span("fit.eval", 310.0, 100.0)
    ev.launch(312.0, 320.0, 60.0, "eval")
    ev.span("fit.read", 411.0, 5.0)
    ev.launch(412.0, 413.0, 1.0, "Memcpy DtoH", cat="gpu_memcpy")
    ev.span("checkpoint", 500.0, 210.0)               # the benchmark's own span
    ev.span("checkpoint.save", 505.0, 200.0)
    ev.span("checkpoint.serialize", 506.0, 150.0)
    for k in range(3):
        ev.launch(510.0 + 40 * k, 520.0 + 40 * k, 10.0, "Memcpy DtoH", cat="gpu_memcpy")
    ev.span("checkpoint.swap", 660.0, 40.0)
    ev.span("trace_stop", 999.0, 1.0)
    return ev


def serve_events(calls=3):
    """``calls`` serving calls of 300 us: prep 20 us, h2d 50 us, launch 100 us
    (two K1 launches of 60 us), d2h 100 us."""
    ev = Events()
    ev.span("trace_start", 0.0, 1.0)
    for i in range(calls):
        t = 10.0 + 300.0 * i
        ev.span("predict", t, 290.0)
        ev.span("predict_logits", t + 1, 285.0)
        ev.span("predict.prep", t + 2, 20.0)
        ev.span("predict.h2d", t + 25, 50.0)
        ev.launch(t + 26, t + 30, 40.0, "Memcpy HtoD (Pageable -> Device)", cat="gpu_memcpy")
        ev.span("predict.launch", t + 80, 100.0)
        ev.launch(t + 81, t + 90, 60.0, "stgcan_block_kernel")
        ev.launch(t + 120, t + 150, 60.0, "stgcan_block_kernel")
        ev.span("predict.d2h", t + 185, 100.0)
        ev.launch(t + 186, t + 212, 3.0, "Memcpy DtoH", cat="gpu_memcpy")
    ev.span("trace_stop", 10.0 + 300.0 * calls, 1.0)
    return ev


@pytest.fixture(autouse=True)
def runs(tmp_path, monkeypatch):
    """The folder the device-time readers look for chrome traces in."""
    monkeypatch.setattr(spans, "RUNS", str(tmp_path))
    return tmp_path


def _file(tmp_path, cell, seed=1):
    """Where ``port_bench/run.py`` leaves the chrome trace of a traced run."""
    return str(tmp_path / f"{cell}.{seed}" / "trace.json")


def _run(cell, trace, counters, host):
    c = core.load_cell(ROOT, cell, True)
    return core.Run(c, H100, 1.0, host, trace, counters, costs.peaks(H100))


def _read(cell, names, run):
    c = core.load_cell(ROOT, cell, True)
    return {n: c.readers[n].read(run) for n in names}


def test_the_new_train_metrics_read_the_phases(tmp_path):
    t = train_events().write(_file(tmp_path, "gstcan3-train-b1024"))
    run = _run("gstcan3-train-b1024", t, {"train_steps": 2},
               {"traced_steps": 2, "traced_windows": 2048})
    got = _read("gstcan3-train-b1024", NEW_TRAIN, run)
    assert got["gather_ms.train"] == pytest.approx(5e-3)      # 5 us a step, in ms
    assert got["forward_ms.train"] == pytest.approx(20e-3)
    assert got["backward_ms.train"] == pytest.approx(40e-3)  # launched from thread 2
    assert got["optimizer_ms.train"] == pytest.approx(10e-3)  # inside torch's own span
    assert got["eval_ms.train"] == pytest.approx(0.06)     # its kernel; the read is fit.read's
    # 200 us inside checkpoint.save, 30 us of it busy, in a window of 1,000 us
    assert got["checkpoint_stall.train"] == pytest.approx(17.0)


def test_the_new_serve_metrics_read_the_call_spans(tmp_path):
    t = serve_events().write(_file(tmp_path, "gstcan3-serve-b128"))
    run = _run("gstcan3-serve-b128", t, {"predict_calls": 3}, {"traced_windows": 384})
    got = _read("gstcan3-serve-b128", NEW_SERVE, run)
    assert got == pytest.approx({"prep_ms.serve": 0.02, "h2d_ms.serve": 0.05,
                                 "launch_ms.serve": 0.1})


def test_without_the_systems_spans_or_counters_the_new_metrics_read_nothing(tmp_path):
    t = train_events().write(_file(tmp_path, "gstcan3-train-b1024"), system=False)
    run = _run("gstcan3-train-b1024", t, {}, {"traced_steps": 2, "traced_windows": 2048})
    assert set(_read("gstcan3-train-b1024", NEW_TRAIN, run).values()) == {None}
    s = serve_events().write(_file(tmp_path, "gstcan3-serve-b128"), system=False)
    run = _run("gstcan3-serve-b128", s, {}, {"traced_windows": 384})
    assert set(_read("gstcan3-serve-b128", NEW_SERVE, run).values()) == {None}
    untraced = _run("gstcan3-train-b1024", None, {}, {"traced_steps": 0, "traced_windows": 0})
    assert set(_read("gstcan3-train-b1024", NEW_TRAIN, untraced).values()) == {None}


@pytest.mark.parametrize("cell,names,events,host", [
    ("gstcan3-train-b1024", OLD_TRAIN, train_events,
     {"traced_steps": 2, "traced_windows": 2048}),
    ("gstcan3-serve-b128", OLD_SERVE, serve_events, {"traced_windows": 384}),
    ("stgcan-serve-b128", OLD_SERVE, serve_events, {"traced_windows": 384}),
])
def test_the_metrics_the_benchmark_had_read_the_same_with_the_systems_spans(
        tmp_path, cell, names, events, host):
    ev = events()
    with_spans = ev.write(_file(tmp_path, cell, 1))
    without = ev.write(_file(tmp_path, cell, 2), system=False)
    counters = {"k1_launches": 6, "k2_launches": 0, "predict_calls": 3, "train_steps": 2}
    c = core.load_cell(ROOT, cell, True)
    names = [n for n in names if n in c.readers]
    a = _read(cell, names, _run(cell, with_spans, counters, host))
    b = _read(cell, names, _run(cell, without, counters, host))
    assert a == b and any(v is not None for v in a.values())
    assert with_spans.device.names == without.device.names
    if "idle_share.train" in a:
        # busy: 2 x (5 + 20 + 40 + 10) + 60 + 1 + 30 = 241 us of 1,000
        assert a["idle_share.train"] == pytest.approx(75.9)
        assert a["device_ops_per_step.train"] == pytest.approx(13 / 2)


def test_the_spans_cover_the_work(tmp_path):
    path = _file(tmp_path, "gstcan3-train-b1024")
    assert spans.busy_in_port_spans(train_events().write(path), path) == pytest.approx(1.0)
    ev, path = serve_events(), _file(tmp_path, "gstcan3-serve-b128")
    assert spans.busy_in_port_spans(ev.write(path), path) == pytest.approx(1.0)
    assert spans.idle_in_port_spans(ev.write(path)) == pytest.approx(1.0)
    # the window runs on 100 us after the last call: a gap of 186 us whose
    # middle lies in no span, of 522 us idle in all
    ev.events[-1]["ts"] += 100.0
    s = ev.write(_file(tmp_path, "gstcan3-serve-b128", 2))
    assert spans.idle_in_port_spans(s) == pytest.approx(1 - 186 / 522)
    assert dict(s.idle_by_span(20))["outside any span (1 gaps)"] == pytest.approx(186e-6)


def test_a_launch_outside_any_port_span_counts_against_coverage(tmp_path):
    ev = train_events()
    ev.launch(994.0, 995.0, 4.0, "stray")                # after fit.epoch, in the window
    path = _file(tmp_path, "gstcan3-train-b1024")
    assert spans.busy_in_port_spans(ev.write(path), path) == pytest.approx(241 / 245)


def test_idle_time_is_split_by_the_innermost_port_span_over_each_part(tmp_path):
    s = serve_events().write(_file(tmp_path, "gstcan3-serve-b128"))
    got = spans.idle_by_phase(s)
    want = {"predict.h2d": 30, "predict_logits": 30, "predict.launch": 30, "predict.d2h": 216,
            "predict.prep": 60, "": 56}                  # us; the harness's own spans count as ""
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(s.window_s - s.busy_s())


def test_the_device_time_readers_find_the_chrome_trace_of_their_window(tmp_path):
    cell = "gstcan3-train-b1024"
    t = train_events().write(_file(tmp_path, cell, 1))
    later = train_events()
    later.events[-1]["ts"] += 50.0                        # another run: another window
    other = later.write(_file(tmp_path, cell, 2))
    assert spans.trace_file(t, cell) == _file(tmp_path, cell, 1)
    assert spans.trace_file(other, cell) == _file(tmp_path, cell, 2)
    assert spans.trace_file(other) == _file(tmp_path, cell, 2)
    assert spans.trace_file(t, "gstcan3-serve-b128") is None
    with pytest.raises(ValueError):
        spans.launched(t, _file(tmp_path, cell, 2))
    run = _run(cell, t, {"train_steps": 2}, {"traced_steps": 2, "traced_windows": 2048})
    assert spans.device_ms(run, "step.forward", 2) == pytest.approx(20e-3)
    os.remove(_file(tmp_path, cell, 1))                   # the file is gone: nothing to read
    assert spans.device_ms(run, "step.forward", 2) is None
