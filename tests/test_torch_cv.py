"""The port's k-fold cross-validation, grid search, fold artifacts, the
trainer CLI's ``--cv``/``--grid``/observability flags and the profiling
helpers, against the JAX package's ``train/cv.py``, ``cli.py`` and
``utils/profiling.py``, on the CPU at small widths."""

import csv
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from fall_multimodal_tpu import cli as jax_cli
from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from fall_multimodal_tpu.train import cv as jax_cv
from fall_multimodal_tpu_torch import cli
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import make_synthetic
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.train import cv
from fall_multimodal_tpu_torch.train.loop import FitResult
from fall_multimodal_tpu_torch.utils import profiling

torch.set_num_threads(1)

OVERRIDES = {"data.num_classes": 3, "data.n_folds": 3, "data.sensor_dim": 6,
             "model.kwargs.hidden_size": 8}
TINY_STAGES = "model.kwargs.stages=[[16,1,false],[16,1,true],[32,2,true]]"
DATA = dict(n_windows=120, num_classes=3, sensor_dim=6, windows_per_video=8, noise=0.05,
            seed=0)


@pytest.fixture(scope="module")
def jax_and_port():
    """JAX's and the port's CV on the same config and data (2 folds x 1 epoch)."""
    ours = cv.cross_validate(load_config(preset_path("bilstm"), overrides=OVERRIDES),
                             make_synthetic(**DATA), n_folds=2, epochs=1, device="cpu")
    ref = jax_cv.cross_validate(jax_load_config(jax_preset_path("bilstm"),
                                                overrides=OVERRIDES),
                                jax_make_synthetic(**DATA), n_folds=2, epochs=1)
    return ours, ref


def test_cross_validate_rows_and_summary_have_the_jax_structure(jax_and_port):
    ours, ref = jax_and_port
    assert set(ours) == set(ref) == {"folds", "summary"}
    assert [list(r) for r in ours["folds"]] == [list(r) for r in ref["folds"]]
    assert [r["fold"] for r in ours["folds"]] == [0, 1]
    assert list(ours["summary"]) == list(ref["summary"])
    for m in (k for k in ours["folds"][0] if k != "fold"):
        vals = [r[m] for r in ours["folds"]]
        assert ours["summary"][f"{m}_mean"] == pytest.approx(np.mean(vals), abs=1e-12)
        assert ours["summary"][f"{m}_std"] == pytest.approx(np.std(vals), abs=1e-12)
        assert all(0.0 <= v <= 1.0 for v in vals)
    json.dumps(ours)            # cv_results.json stays plain JSON


def test_cross_validate_writes_fold_checkpoints_and_calls_the_factories(tmp_path):
    cfg = load_config(preset_path("bilstm"), overrides=OVERRIDES)
    seen = {0: [], 1: []}

    def factory(i):
        return lambda epoch, scalars: seen[i].append((epoch, sorted(scalars)))

    cv.cross_validate(cfg, make_synthetic(**DATA), n_folds=2, epochs=2, device="cpu",
                      checkpoint_dir=str(tmp_path / "ckpt"), metrics_factory=factory)
    for i in (0, 1):
        for name in ("best", "latest"):
            assert os.path.exists(tmp_path / "ckpt" / f"fold{i}" / name / "checkpoint.pt")
        assert [e for e, _ in seen[i]] == [1, 2]
        assert seen[i][0][1] == ["train_accuracy", "train_loss", "val_accuracy", "val_loss"]


def _fit_result(history, test=None):
    return FitResult(state=None, best_state=None, best_val_accuracy=0.5, history=history,
                     test=test)


def test_history_csv_is_padded_after_a_nan_break_as_in_the_jax_package(tmp_path):
    hist = {"train_loss": [0.9, float("nan")], "train_acc": [0.4], "val_loss": [0.8],
            "val_acc": [0.5], "epoch_time": [1.25]}
    cv._write_fold_artifacts(str(tmp_path / "ours"), 1, _fit_result(hist))
    jax_cv._write_fold_artifacts(str(tmp_path / "jax"), 1, _fit_result(hist))
    ours = (tmp_path / "ours" / "fold1" / "history.csv").read_text()
    assert ours == (tmp_path / "jax" / "fold1" / "history.csv").read_text()
    rows = list(csv.reader(ours.splitlines()))
    assert rows[0] == ["epoch", "train_loss", "train_acc", "val_loss", "val_acc", "epoch_time"]
    assert rows[2] == ["2", "nan", "", "", "", ""]


def test_confusion_png_is_skipped_cleanly_without_matplotlib(tmp_path, monkeypatch, caplog):
    from fall_multimodal_tpu_torch.train.loop import EvalResult

    test = EvalResult(loss=0.5, accuracy=0.5, confusion=np.array([[2.0, 1.0], [1.0, 2.0]]),
                      stats={})
    hist = {"train_loss": [0.9], "val_acc": [0.5]}
    cv._write_fold_artifacts(str(tmp_path / "with"), 0, _fit_result(hist, test))
    assert os.path.exists(tmp_path / "with" / "fold0" / "confusion.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    logger = logging.getLogger("test_torch_cv")
    with caplog.at_level(logging.WARNING, logger="test_torch_cv"):
        cv._write_fold_artifacts(str(tmp_path / "without"), 0, _fit_result(hist, test),
                                 logger=logger)
    assert not os.path.exists(tmp_path / "without" / "fold0" / "confusion.png")
    assert os.path.exists(tmp_path / "without" / "fold0" / "history.csv")
    assert "matplotlib unavailable; skipping confusion.png for fold 0" in caplog.text


def test_grid_search_keeps_grid_order_and_ranks():
    cfg = load_config(preset_path("bilstm"), overrides=OVERRIDES)
    rows = cv.grid_search(cfg, make_synthetic(**DATA), {"hidden_size": [8, 16]}, epochs=1,
                          device="cpu")
    assert [r["hidden_size"] for r in rows] == [8, 16]
    assert list(rows[0]) == ["hidden_size", "val_accuracy", "test_accuracy", "rank"]
    assert sorted(r["rank"] for r in rows) == [1, 2]
    best = min(rows, key=lambda r: r["rank"])
    assert best["val_accuracy"] == max(r["val_accuracy"] for r in rows)
    assert cv.reference_grid() == jax_cv.reference_grid()


# ---------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv", [
    ["--cv", "--resume", "x"], ["--grid", "--pretrained", "x"], ["--cv", "--test-only"],
    ["--grid", '{"embed_dim": [8]}', "--test-only"], ["--epochs", "0"],
    ["--cv-mesh", "2"], ["--cv", "--cv-mesh", "2"], ["--cv-vmapped", "--mesh", "2"],
    ["--cv-vmapped", "--resume", "x"], ["--cv-vmapped", "--test-only"],
])
def test_flag_conflicts_are_rejected_before_data_loads(monkeypatch, argv):
    def boom(*a, **k):
        raise AssertionError("config was loaded before the flags were checked")

    monkeypatch.setattr(cli, "load_cli_config", boom)
    monkeypatch.setattr(jax_cli, "load_cli_config", boom)
    msgs = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["--config", "bilstm", "--device", "cpu", *argv] if main is cli.main
                 else ["--config", "bilstm", *argv])
        msgs.append(str(exc.value))
    assert msgs[0].split(";")[0] == msgs[1].split(";")[0]


def test_tensorboard_without_the_package_exits_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(cli, "load_cli_config", lambda *a: pytest.fail("loaded config"))
    for flag in ("--tensorboard", "--grad-norms"):
        with pytest.raises(SystemExit, match="'tensorboard' package"):
            cli.main(["--config", "bilstm", "--device", "cpu", "--cv", flag])


def test_cli_cv_writes_results_folds_and_checkpoints(tmp_path):
    out = str(tmp_path / "cv")
    res = cli.main(["--config", "gstcan_urfall_3stream", "--device", "cpu", "--cv",
                    "--folds", "2", "--epochs", "1", "--set", "train.batch_size=16",
                    "--set", TINY_STAGES, "--synthetic-windows", "96", "--output-dir", out])
    with open(os.path.join(out, "cv_results.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(res))
    assert len(res["folds"]) == 2
    for i in (0, 1):
        with open(os.path.join(out, f"fold{i}", "history.csv")) as fh:
            assert len(fh.read().strip().splitlines()) == 2
        for name in ("best", "latest"):
            assert os.path.exists(os.path.join(out, "ckpt", f"fold{i}", name, "checkpoint.pt"))
    with open(os.path.join(out, "log.txt")) as fh:
        log = fh.read()
    assert "model summary:" in log and "TOTAL" in log


def test_cli_grid_writes_ranked_rows_in_grid_order(tmp_path):
    out = str(tmp_path / "grid")
    res = cli.main(["--config", "musa_harup", "--device", "cpu", "--grid",
                    '{"embed_dim": [8, 16]}', "--epochs", "1", "--set",
                    "model.kwargs.n_stage=1", "--set", "train.batch_size=16",
                    "--synthetic-windows", "64", "--output-dir", out])
    with open(os.path.join(out, "grid_results.csv")) as fh:
        rows = list(csv.DictReader(fh))
    assert [r["embed_dim"] for r in rows] == ["8", "16"]
    assert sorted(r["rank"] for r in rows) == ["1", "2"]
    with open(os.path.join(out, "grid_results.json")) as fh:
        assert json.load(fh) == res["grid"]
    with pytest.raises(SystemExit, match="dict of lists"):
        cli.main(["--config", "musa_harup", "--device", "cpu", "--grid", "[1, 2]",
                  "--output-dir", out, "--synthetic-windows", "16"])


class _FakeWriter:
    seen = []

    def __init__(self, log_dir=None):
        self.closed = False

    def close(self):
        self.closed = True

    def add_scalar(self, name, value, step):
        self.seen.append((name, step))


@pytest.mark.parametrize("mode,flag,prefix", [
    (["--cv", "--folds", "2"], "--tensorboard", "fold"),
    (["--cv", "--folds", "2"], "--grad-norms", "fold"),
    (["--grid", '{"hidden_size": [8, 16]}'], "--tensorboard", "point"),
])
def test_cli_scalars_are_tagged_by_fold_or_point(tmp_path, monkeypatch, mode, flag, prefix):
    import torch.utils.tensorboard as tb

    _FakeWriter.seen = []
    monkeypatch.setattr(tb, "SummaryWriter", _FakeWriter)
    cli.main(["--config", "bilstm", "--device", "cpu", "--set", "data.num_classes=3",
              "--epochs", "2", *mode, flag, "--output-dir", str(tmp_path / "tb"),
              "--synthetic-windows", "64"])
    seen = _FakeWriter.seen
    tags = {n.split("/")[0] for n, _ in seen if "/" in n and not n.startswith("grad_norm")}
    assert tags == {f"{prefix}0", f"{prefix}1"}, tags
    for tag in tags:
        assert sorted(s for n, s in seen if n == f"{tag}/val_accuracy") == [1, 2]
    assert any("/grad_norm/" in n for n, _ in seen) == (flag == "--grad-norms")


def test_cli_profile_writes_a_trace(tmp_path):
    out = str(tmp_path / "prof")
    cli.main(["--config", "bilstm", "--device", "cpu", "--set", "data.num_classes=3",
              "--epochs", "1", "--profile", "--output-dir", out, "--synthetic-windows", "64"])
    with open(os.path.join(out, "profile", "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


# ----------------------------------------------------------- profiling

def test_model_summary_lists_every_parameter():
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    model = build_model(cfg)
    text = profiling.model_summary(model)
    lines = text.splitlines()
    assert len(lines) == len(list(model.named_parameters())) + 2
    total = sum(p.numel() for p in model.parameters())
    assert lines[-1].split()[-1] == f"{total:,}"
    assert "fcn.weight" in text


def test_throughput_counts_windows():
    tp = profiling.Throughput()
    tp.update(64)
    tp.update(64)
    assert tp.windows_per_sec > 0


def test_nan_debug_raises_at_the_nan_and_restores_the_setting():
    before = torch.is_anomaly_enabled()
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with profiling.nan_debug():
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == before
    with profiling.nan_debug(False):
        torch.sqrt(x).sum().backward()
    assert torch.isnan(x.grad).any()
