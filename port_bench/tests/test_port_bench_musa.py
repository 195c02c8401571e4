"""The ``musa_harup`` configuration and its cell ``musa-train-b256``: the
system's configuration at the published widths and train seed; the
reference's FLOP count through the harness; the cell end to end on the CPU
through ``run.execute`` at a small width (``make_cell``'s overrides), and
``TrainJob``'s reference reading the system's own first steps, masks and
all; and the cell's two per-layer metrics on a hand-built chrome trace,
which read nothing from a program without musa's spans or counter."""

import json
import os
import shutil

import pytest
import torch

from port_bench import run
from port_bench.harness import core, costs, generators, spans
from port_bench.harness import trace as tr
from port_bench.harness.trace import Tracer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = "musa-train-b256"
SEED = 2 ** 31 + 2121
H100 = "NVIDIA H100 80GB HBM3"
NEW = ("dropgraph_ms.train", "sep_temporal_ms.train")
DRAWS = "fall_multimodal_tpu_torch.models.musa:_DropGraphBlock.draws"
SMALL = {"config": {"model": {"kwargs": {"embed_dim": 8}}},
         "traffic": {"windows": 192, "batch_size": 8, "trace_epochs": 1}}
# Limits of the cell at SMALL on the CPU, where the system's BatchNorm
# (F.batch_norm) loses digits of a channel's variance that the card's does
# not (tests/test_torch_musa_reference.py): on two threads, as run.py runs,
# the system read up to 8.9e-6, 0.033, 0.20 and 4.0e-5 over 8 seeds; a
# generator started elsewhere read from 3.6e-3 in the loss and 4.7e-3 in
# the statistics.
CPU_LIMITS = {"first_loss_gap": {"limit": 5e-5}, "grad_gap": {"limit": 0.1},
              "change_gap": {"limit": 0.5}, "stats_gap": {"limit": 2e-4}}


def cpu_checkout(tmp_path):
    """A copy of the benchmark whose limits for the cell are CPU_LIMITS."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    (root / "port_bench" / "limits" / f"{CELL}.json").write_text(json.dumps(CPU_LIMITS))
    return str(root)


@pytest.fixture(scope="module")
def cell():
    return core.load_cell(ROOT, CELL, True)


def test_port_config_builds_the_published_model_and_job(cell):
    from fall_multimodal_tpu_torch.models.registry import build_model

    cfg = core.port_config(cell.config)
    m = cell.config["model"]
    assert cfg.model.name == "musa" and cfg.model.kwargs == {
        "embed_dim": 64, "n_stage": 1, "act_type": "tanh", "keep_prob": 0.9, "block_size": 41,
        "edge": True, "bias": True, "dropout": 0.2}
    assert (cfg.data.num_joints, cfg.data.seq_len, cfg.data.in_channels,
            cfg.data.num_classes) == (14, 30, 3, 11)
    assert (cfg.train.batch_size, cfg.train.epochs, cfg.optim.type, cfg.optim.lr) == \
        (256, 100, "rmsprop", 0.001)
    # the reference's generator is seeded as the system's train state is
    assert cfg.seed == m["train_seed"] == 42
    model = build_model(cfg)
    assert sum(p.numel() for p in model.parameters()) == m["parameters"] == 427_107
    assert cell.traffic["batch_size"] == 256 and cell.traffic["windows"] == 16384
    assert cell.config["reduced"] == []
    k, nnz = costs.adjacency_counts()
    assert costs.forward_flops(m, k, nnz) == 176_130_560


def test_the_cell_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    root = cpu_checkout(tmp_path)
    plain = run.execute(CELL, SEED, 0.5, False, device="cpu", root=root, overrides=SMALL)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"train_windows_per_s", "setup_s"}
    assert set(plain["checks"]) == {"first_loss_gap", "grad_gap", "change_gap", "stats_gap"}
    assert plain["attempted"] > 0 and plain["failed"] == 0
    monkeypatch.setattr(spans, "RUNS", os.path.join(root, "port_bench", "runs"))
    traced = run.execute(CELL, SEED, 0.5, True, device="cpu", root=root, overrides=SMALL)
    assert traced["correct"]
    # no card: the device readers, the new ones among them, read nothing
    assert not set(NEW) & set(traced["metrics"])


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize("seed", [SEED, 2 ** 32 + 5])
def test_the_reference_reads_the_systems_first_steps_with_the_same_masks(two_threads, seed):
    """``TrainJob`` takes three steps of the system from its train state's
    generator; the reference made anew for each reading draws the same masks
    (the readings stay inside the limits), and one whose generator starts
    elsewhere does not."""
    cell = core.load_cell(ROOT, CELL, False, SMALL)
    ctx = core.Ctx(cell, seed, 0.0, torch.device("cpu"), Tracer(False, ""), 0.0)
    job = generators.TrainJob(ctx)
    job.free_program()
    for _ in range(2):
        same = job.compare(job.program, job.reference())
        assert all(same[n] <= CPU_LIMITS[n]["limit"] for n in CPU_LIMITS), same
    cell.config["model"]["train_seed"] = 43
    other = job.compare(job.program, job.reference())
    assert other["first_loss_gap"] >= 10 * CPU_LIMITS["first_loss_gap"]["limit"]
    assert other["stats_gap"] >= 10 * CPU_LIMITS["stats_gap"]["limit"]


class Events:
    """Chrome-trace events, times in microseconds."""

    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, ts, dur):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                            "dur": dur})

    def launch(self, at, start, dur, name="k"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "ts": at, "dur": 2.0, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
                            "args": {"correlation": self.corr}})

    def write(self, path, system=True):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        keep = [e for e in self.events if system or not e["name"].startswith("musa.")]
        with open(path, "w") as fh:
            json.dump({"traceEvents": keep}, fh)
        return tr.parse_chrome_trace(path, ("trace_start", "trace_stop"))


def train_events(steps=2):
    """``steps`` train steps of 1,000 us, each forward with one
    ``musa.temporal`` span launching two 50 us kernels, one
    ``musa.dropgraph`` span launching one of 30 us and one ``musa.graph``
    span launching one of 20 us, and a backward kernel of 400 us; then an
    eval forward whose ``musa.temporal`` span launches a 70 us kernel
    outside any step."""
    ev = Events()
    ev.span("trace_start", 0.0, 1.0)
    for i in range(steps):
        t = 10.0 + 1000.0 * i
        ev.span("train.step", t, 990.0)
        ev.span("step.forward", t + 5, 300.0)
        ev.span("musa.graph", t + 10, 10.0)
        ev.launch(t + 11, t + 20, 20.0)
        ev.span("musa.temporal", t + 30, 20.0)
        ev.launch(t + 31, t + 50, 50.0)
        ev.launch(t + 32, t + 110, 50.0)
        ev.span("musa.dropgraph", t + 60, 10.0)
        ev.launch(t + 61, t + 170, 30.0)
        ev.span("step.backward", t + 320, 600.0)
        ev.launch(t + 321, t + 400, 400.0)
    t = 10.0 + 1000.0 * steps
    ev.span("fit.eval", t, 300.0)
    ev.span("musa.temporal", t + 10, 10.0)
    ev.launch(t + 11, t + 50, 70.0)
    ev.span("trace_stop", t + 400, 1.0)
    return ev


def traced_run(cell, t, counters):
    return core.Run(cell, H100, 1.0, {"traced_windows": 2 * 256}, t, counters, costs.peaks(H100))


def test_the_new_metrics_read_the_train_forwards_musa_spans(tmp_path, monkeypatch, cell):
    monkeypatch.setattr(spans, "RUNS", str(tmp_path))
    t = train_events().write(str(tmp_path / f"{CELL}.1" / "trace.json"))
    got = {n: cell.readers[n].read(traced_run(cell, t, {"train_steps": 2,
                                                         "dropgraph_draws": 24}))
           for n in NEW}
    assert got["sep_temporal_ms.train"] == pytest.approx(0.1)     # the eval forward's left out
    assert got["dropgraph_ms.train"] == pytest.approx(0.03)
    assert cell.readers["dropgraph_ms.train"].COUNTERS == {"train_steps": spans.TRAIN_STEPS,
                                                          "dropgraph_draws": DRAWS}


def test_without_musas_spans_or_counter_the_new_metrics_read_nothing(tmp_path, monkeypatch,
                                                                     cell):
    monkeypatch.setattr(spans, "RUNS", str(tmp_path))
    t = train_events().write(str(tmp_path / f"{CELL}.2" / "trace.json"), system=False)
    older = traced_run(cell, t, {"train_steps": 2})
    assert {n: cell.readers[n].read(older) for n in NEW} == dict.fromkeys(NEW)
    t = train_events().write(str(tmp_path / f"{CELL}.3" / "trace.json"))
    skipped = traced_run(cell, t, {"train_steps": 2, "dropgraph_draws": 0})
    assert cell.readers["dropgraph_ms.train"].read(skipped) is None
    untraced = traced_run(cell, None, {})
    assert {n: cell.readers[n].read(untraced) for n in NEW} == dict.fromkeys(NEW)
