"""The ``targcn_harup`` configuration and its cell ``targcn-serve-b8192``:
the system's configuration at the published widths; the reference's hooks
(its raw leaves, its FLOP count against torch's counter, seeded scales that
leave the gates unsaturated); the cell end to end on the CPU through
``run.execute`` on a checkout whose traffic is cut to a few windows; and the
cell's three per-layer metrics on a hand-built chrome trace, which read
nothing from a program without TARGCN's spans and counter."""

import json
import os
import shutil

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import run
from port_bench.harness import core, costs, data, spans
from port_bench.harness import trace as tr
from port_bench.harness.weights import seed_weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = "targcn-serve-b8192"
SEED = 2 ** 31 + 1616
H100 = "NVIDIA H100 80GB HBM3"
NEW = ("recurrence_ms.serve", "transformer_ms.serve", "recurrence_roofline.serve")
STEPS = "fall_multimodal_tpu_torch.models.targcn:GraphGRUCell.steps"


@pytest.fixture(scope="module")
def cell():
    return core.load_cell(ROOT, CELL, True)


@pytest.fixture(scope="module")
def ref(cell):
    return core.reference(cell)


def test_port_config_builds_the_published_widths(cell):
    from fall_multimodal_tpu_torch.models.registry import build_model

    cfg = core.port_config(cell.config)
    assert cfg.model.name == "targcn"
    assert cfg.model.kwargs == {"rnn_units": 64, "embed_dim": 64, "output_dim": 64,
                                "horizon": 30, "context_steps": 6, "num_layers": 2,
                                "gcn_variant": "gated"}
    assert (cfg.data.num_joints, cfg.data.seq_len, cfg.data.in_channels,
            cfg.data.num_classes) == (14, 30, 3, 11)
    model = build_model(cfg)
    assert model.encoder.dcrnn_cells[0].gate.linear is not None          # the gated variant
    assert sum(p.numel() for p in model.parameters()) == 3_235_763
    assert cell.traffic["batch"] == 8192 and cell.traffic["pool_batches"] == 8
    assert cell.config["reduced"] == []


def test_raw_leaves_yields_exactly_the_three_raw_leaves(cell, ref):
    model = ref.build(cell.config["model"])
    names = {id(p): n for n, p in model.named_parameters()}
    for scheme in ("init", "trained"):
        got = sorted(names[id(t)] for t, _, _ in ref.raw_leaves(model, scheme))
        assert {n.split(".")[-1] for n in got} == {"node_embeddings", "weights_pool",
                                                    "bias_pool"}
        assert got == sorted(n for n in names.values()
                             if n.endswith(("node_embeddings", "weights_pool", "bias_pool")))
        assert len(got) == 1 + 2 * 2 * 2                # E, and two pools a GCN, 2 a layer


def test_forward_flops_agrees_with_torchs_counter(cell, ref):
    """FlopCounterMode on the reference at batch 64 and at batch 1: the
    difference is 63 windows' work, the per-call weight generation (which
    the reference recomputes every frame) taken out."""
    model = ref.build(cell.config["model"]).eval()

    def counted(batch):
        x = torch.rand(batch, 30, 14, 3, generator=torch.Generator().manual_seed(batch))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
        return counter.get_total_flops()

    per_window = (counted(64) - counted(1)) / 63
    assert ref.forward_flops(cell.config["model"]) == pytest.approx(per_window, rel=0.01)
    k, nnz = costs.adjacency_counts()
    assert costs.forward_flops(cell.config["model"], k, nnz) == \
        ref.forward_flops(cell.config["model"])
    flops, nbytes = ref.recurrence_cost(cell.config["model"], 8192)
    assert flops > 8192 * 67e6 and nbytes > 4 * 2 * 8192 * 30 * 14 * 64


def test_seeded_gates_are_not_saturated(cell, ref):
    """Under the cell's seeded weights at the published widths, fewer than
    one in ten of the gates' and the static branches' pre-activations lie
    beyond 6 in size (sigmoid's slope there is under 0.0025)."""
    m = cell.config["model"]
    model = ref.build(m)
    w = data.make_windows(64, m["seq_len"], m["num_joints"], m["num_classes"], 0,
                          cell.traffic["noise"], SEED)
    x = torch.from_numpy(w.pose)
    seed_weights(model, SEED, "trained", condition=(x, None), reference=ref)
    seen = []
    hooks = [mod.register_forward_hook(lambda mod, i, o: seen.append(o.detach().flatten()))
             for name, mod in model.named_modules()
             if name.endswith(("gate", "update", "gate.linear", "update.linear"))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    assert len(seen) == 2 * 2 * 2 * 30
    pre = torch.cat(seen)
    assert float((pre.abs() > 6).float().mean()) < 0.1
    assert float(pre.std()) > 0.1                       # and not flat either


def small_checkout(tmp_path):
    """A copy of the benchmark whose ``serve_b8192`` traffic holds two
    batches of four windows."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    path = root / "port_bench" / "traffic" / "serve_b8192.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), batch=4, pool_batches=2,
                                    trace_seconds=0.3)))
    return str(root)


def test_the_cell_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    root = small_checkout(tmp_path)
    plain = run.execute(CELL, SEED, 0.3, False, device="cpu", root=root)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"serve_windows_per_s", "setup_s"}
    assert plain["attempted"] % 4 == 0 and plain["attempted"] > 0 and plain["failed"] == 0
    assert plain["checks"]["logit_gap"]["value"] <= plain["checks"]["logit_gap"]["limit"]
    monkeypatch.setattr(spans, "RUNS", os.path.join(root, "port_bench", "runs"))
    traced = run.execute(CELL, SEED, 0.6, True, device="cpu", root=root)
    assert traced["correct"]
    # the card's time and peaks are not on the CPU: the device readers give nothing
    assert {"prep_ms.serve", "h2d_ms.serve", "launch_ms.serve"} <= set(traced["metrics"])
    assert not set(NEW) & set(traced["metrics"])


class Events:
    """Chrome-trace events, times in microseconds."""

    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, ts, dur):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                            "dur": dur})

    def launch(self, at, start, dur, name="k", cat="kernel"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "ts": at, "dur": 2.0, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": start, "dur": dur,
                            "args": {"correlation": self.corr}})

    def write(self, path, system=True):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        keep = [e for e in self.events if system or not (
            e["cat"] == "cuda_runtime" or e["name"].startswith("targcn."))]
        with open(path, "w") as fh:
            json.dump({"traceEvents": keep}, fh)
        return tr.parse_chrome_trace(path, ("trace_start", "trace_stop"))


def serve_events(calls=2):
    """``calls`` TARGCN calls of 1,000 us. Inside ``predict.launch``: two
    recurrence spans, each launching two 100 us kernels that run while the
    host goes on (the second span's start after the first's kernels), the
    transformer launching one of 80 us, the head one of 20 us."""
    ev = Events()
    ev.span("trace_start", 0.0, 1.0)
    for i in range(calls):
        t = 10.0 + 1000.0 * i
        ev.span("predict", t, 990.0)
        ev.span("predict_logits", t + 1, 985.0)
        ev.span("predict.h2d", t + 5, 20.0)
        ev.launch(t + 6, t + 10, 15.0, "Memcpy HtoD (Pageable -> Device)", cat="gpu_memcpy")
        ev.span("predict.launch", t + 30, 100.0)
        for layer in range(2):
            ev.span("targcn.recurrence", t + 31 + 20 * layer, 15.0)
            for k in range(2):
                ev.launch(t + 32 + 20 * layer + k, t + 40 + 200 * (2 * layer + k), 100.0)
        ev.span("targcn.transformer", t + 80, 10.0)
        ev.launch(t + 81, t + 840, 80.0, "attention")
        ev.span("targcn.head", t + 95, 10.0)
        ev.launch(t + 96, t + 920, 20.0, "end_conv")
        ev.span("predict.d2h", t + 140, 840.0)
        ev.launch(t + 141, t + 950, 2.0, "Memcpy DtoH", cat="gpu_memcpy")
    ev.span("trace_stop", 10.0 + 1000.0 * calls, 1.0)
    return ev


def traced_run(cell, t, counters):
    return core.Run(cell, H100, 1.0, {"traced_windows": 2 * 8192}, t, counters, costs.peaks(H100))


def test_the_new_metrics_read_the_recurrence_and_the_transformer(tmp_path, monkeypatch, cell,
                                                                 ref):
    monkeypatch.setattr(spans, "RUNS", str(tmp_path))
    t = serve_events().write(str(tmp_path / f"{CELL}.1" / "trace.json"))
    got = {n: cell.readers[n].read(traced_run(cell, t, {"predict_calls": 2,
                                                         "targcn_steps": 120}))
           for n in NEW}
    assert got["recurrence_ms.serve"] == pytest.approx(0.4)     # 4 x 100 us a call
    assert got["transformer_ms.serve"] == pytest.approx(0.08)
    least = costs.roofline_ms(*ref.recurrence_cost(cell.config["model"], 8192), costs.PEAKS["H100"])
    assert got["recurrence_roofline.serve"] == pytest.approx(100 * least * 2 / 0.8)
    assert cell.readers["recurrence_roofline.serve"].COUNTERS == {"targcn_steps": STEPS}


def test_without_targcns_spans_or_counter_the_new_metrics_read_nothing(tmp_path, monkeypatch,
                                                                       cell):
    monkeypatch.setattr(spans, "RUNS", str(tmp_path))
    t = serve_events().write(str(tmp_path / f"{CELL}.2" / "trace.json"), system=False)
    old = traced_run(cell, t, {"predict_calls": 2})
    assert {n: cell.readers[n].read(old) for n in NEW} == dict.fromkeys(NEW)
    untraced = traced_run(cell, None, {})
    assert {n: cell.readers[n].read(untraced) for n in NEW} == dict.fromkeys(NEW)
