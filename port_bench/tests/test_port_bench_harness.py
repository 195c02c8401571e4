"""The harness end to end on the CPU at small sizes, its look for a card
skipped: every cell runs and comes out correct; with the timed path broken
underneath it comes out not correct, once for each fault the cell can
have; a cell with a traffic mix and a metric of its own is added by files
alone; and the command refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SMALL = {"config": {"model": {"stages": [[16, 1, False], [16, 1, True], [32, 2, True]]}}}
TRAFFIC = {
    "gstcan3-serve-b128": {"batch": 8, "pool_batches": 3},
    "stgcan-serve-b128": {"batch": 8, "pool_batches": 3},
    "gstcan3-train-b1024": {"windows": 160, "batch_size": 8},
}


def small(cell):
    return {"config": dict(SMALL["config"]), "traffic": TRAFFIC[cell]}


def checkout(tmp_path, workloads=(), end_to_end=()):
    """A copy of the benchmark with more ``workloads`` and ``end_to_end``
    entries in its BENCHMARK.json; no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"] += list(workloads)
    bench["end_to_end"] += list(end_to_end)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def execute(cell, seconds=0.5, root=ROOT):
    return run.execute(cell, 2 ** 31 + 99, seconds, False, device="cpu", root=root,
                       overrides=small(cell))


@pytest.mark.parametrize("cell", sorted(TRAFFIC))
def test_each_cell_runs_and_is_correct(cell):
    res = execute(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


def _alter(logits):
    out = logits.clone() if torch.is_tensor(logits) else logits.copy()
    out[0, 0] += 1.0
    return out


def _half(logits):
    half = len(logits) // 2
    return np.concatenate([logits[:half], logits[:len(logits) - half]])


def serve_faults(monkeypatch, fault):
    from fall_multimodal_tpu_torch.serve import Predictor

    original = Predictor.predict_logits
    fn = _alter if fault == "altered" else _half
    monkeypatch.setattr(Predictor, "predict_logits",
                        lambda self, *a, **k: fn(original(self, *a, **k)))


def train_faults(monkeypatch, fault):
    from fall_multimodal_tpu_torch.models.fusion import ThreeStreamGSTCAN
    from fall_multimodal_tpu_torch.train import loop, optim

    if fault == "unchanged":
        monkeypatch.setattr(optim.Optimizer, "step", lambda self: False)
    elif fault == "half":
        ce = loop.cross_entropy
        monkeypatch.setattr(loop, "cross_entropy",
                            lambda logits, labels, *a, **k: ce(logits[:len(logits) // 2],
                                                               labels[:len(labels) // 2], *a, **k))
    else:
        forward = ThreeStreamGSTCAN.forward
        monkeypatch.setattr(ThreeStreamGSTCAN, "forward",
                            lambda self, *a, **k: _alter(forward(self, *a, **k)))


FAULTS = [("gstcan3-serve-b128", serve_faults, "altered"),
          ("gstcan3-serve-b128", serve_faults, "half"),
          ("stgcan-serve-b128", serve_faults, "altered"),
          ("stgcan-serve-b128", serve_faults, "half"),
          ("gstcan3-train-b1024", train_faults, "unchanged"),
          ("gstcan3-train-b1024", train_faults, "half"),
          ("gstcan3-train-b1024", train_faults, "altered")]


@pytest.mark.parametrize("cell,plant,fault", FAULTS, ids=[f"{c}-{f}" for c, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, plant, fault):
    plant(monkeypatch, fault)
    res = execute(cell)
    assert not res["correct"], res["checks"]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new traffic mix and a new metric, each a file, a limits file and
    the BENCHMARK.json entries: no existing file of the harness changes."""
    cell = {"name": "stgcan-serve-b4", "config": "stgcan_harup", "traffic": "serve_b4",
            "chips": 1, "why": "a test cell"}
    metric = {"name": "calls_per_s", "unit": "calls/s", "better": "higher", "bound": 0.05,
              "source": "host_clock", "workloads": ["stgcan-serve-b4"]}
    root = checkout(tmp_path, [cell], [metric])
    bench = os.path.join(root, "port_bench")
    before = {p: open(os.path.join(HERE, p), "rb").read() for p in
              ("run.py", "harness/core.py", "harness/generators.py")}
    with open(os.path.join(HERE, "traffic", "serve_b128.json")) as fh:
        traffic = json.load(fh)
    traffic.update(batch=4, pool_batches=2)
    with open(os.path.join(bench, "traffic", "serve_b4.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(bench, "metrics", "calls_per_s.py"), "w") as fh:
        fh.write("def read(run):\n    return run.host['calls'] / run.host['window_s']\n")
    with open(os.path.join(bench, "limits", "stgcan-serve-b4.json"), "w") as fh:
        json.dump({"logit_gap": {"limit": 1e-4}}, fh)
    res = run.execute("stgcan-serve-b4", 5, 0.3, False, device="cpu", root=root,
                      overrides={"config": SMALL["config"]})
    assert res["correct"] and set(res["metrics"]) == {"calls_per_s", "setup_s"}
    assert res["metrics"]["calls_per_s"]["unit"] == "calls/s"
    assert res["attempted"] % 4 == 0
    for p, content in before.items():
        assert open(os.path.join(bench, p), "rb").read() == content


def test_the_command_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "gstcan3-serve-b128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_a_train_job_that_goes_non_finite_has_failed(monkeypatch):
    from fall_multimodal_tpu_torch.train import loop

    ce = loop.cross_entropy
    calls = [0]

    def late_nan(*a, **k):
        calls[0] += 1
        out = ce(*a, **k)
        return out * float("nan") if calls[0] > 5 else out    # after the checked steps

    monkeypatch.setattr(loop, "cross_entropy", late_nan)
    res = execute("gstcan3-train-b1024", seconds=2.0)
    assert not res["correct"] and res["failed"] > 0
