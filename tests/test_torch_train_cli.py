"""The port's fit contracts, checkpoints and training CLI, on the CPU (the
JAX package's ``train/loop.py:fit``, ``utils/checkpoint.py`` and the
single-run path of ``cli.py``). Models are the flagship and the single-stream
stgcan cut to a 3-block stage plan (16, 16, 32 channels)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fall_multimodal_tpu_torch import cli
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import make_synthetic, split_dataset, to_device
from fall_multimodal_tpu_torch.interop import load_state_dict_file
from fall_multimodal_tpu_torch.serve import Predictor
from fall_multimodal_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    fit,
    make_train_epoch,
)
from fall_multimodal_tpu_torch.train.cv import run_fold
from fall_multimodal_tpu_torch.train.optim import Optimizer
from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer
from torch_port_helpers import t, to_numpy

torch.set_num_threads(1)

TINY = ((16, 1, False), (16, 1, True), (32, 2, True))
TINY_SET = "model.kwargs.stages=[[16,1,false],[16,1,true],[32,2,true]]"


def _cfg(preset="gstcan_urfall_3stream", **train):
    cfg = load_config(preset_path(preset))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, kwargs=dict(cfg.model.kwargs, stages=TINY)),
        train=dataclasses.replace(cfg.train, **train))


def _splits(cfg, n=160, seed=0, split=(0.7, 0.15, 0.15)):
    d = cfg.data
    data = make_synthetic(n_windows=n, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          noise=0.05, windows_per_video=8, seed=seed)
    return {k: to_device(v, "cpu") for k, v in split_dataset(data, split=split, seed=1).items()}


def _state(cfg, **kw):
    return create_train_state(cfg, build_optimizer(cfg, **kw), seed=cfg.seed, device="cpu")


def _fit(state, splits, cfg, epochs, **kw):
    return fit(state, splits, epochs=epochs, batch_size=cfg.train.batch_size,
               num_classes=cfg.data.num_classes,
               softmax_before_ce=cfg.model.softmax_output, **kw)


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ------------------------------------------------------------------ fit

def test_tiny_three_stream_learns_synthetic():
    """As the JAX package's ``test_three_stream_gstcan_learns_synthetic``."""
    cfg = _cfg()
    result = _fit(_state(cfg), _splits(cfg), cfg, epochs=6)
    assert result.history["train_acc"][-1] > 0.8
    assert result.history["train_loss"][-1] < result.history["train_loss"][0]
    assert result.test is not None and result.test.confusion.sum() == _splits(cfg)["test"].n
    assert len(result.history["epoch_time"]) == 6


def test_empty_validation_split_raises():
    cfg = _cfg()
    splits = _splits(cfg, n=24, split=(1.0, 0.0, 0.0))
    assert splits["valid"].n == 0
    with pytest.raises(ValueError, match="empty split"):
        _fit(_state(cfg), splits, cfg, epochs=1)


def test_nan_guard_stops_and_keeps_the_best_state():
    cfg = _cfg("default_urfall", batch_size=16)
    splits = _splits(cfg, n=96)
    steps = splits["train"].n // 16
    state = _state(cfg)
    # epoch 2's learning rate is NaN: its parameters, then its loss, go NaN
    state.optimizer.lr = lambda g: 1e-3 if g < steps else float("nan")
    result = _fit(state, splits, cfg, epochs=4)
    h = result.history
    assert len(h["train_loss"]) == 2 and np.isnan(h["train_loss"][1])
    assert len(h["train_acc"]) == len(h["val_acc"]) == 1
    assert all(torch.isfinite(p).all() for p in result.best_state.model.parameters())
    assert not all(torch.isfinite(p).all() for p in result.state.model.parameters())
    assert result.test is not None and np.isfinite(result.test.loss)


def test_best_state_is_not_moved_by_later_steps(tmp_path):
    cfg = _cfg("default_urfall", batch_size=16)
    splits = _splits(cfg, n=96)
    state = _state(cfg)
    # nothing beats the initial best: the best state must stay the given one
    given = state.snapshot()
    before = _weights(given.model)
    result = _fit(state, splits, cfg, epochs=2, initial_best_acc=1.0,
                  initial_best_state=given)
    assert result.best_state is given and result.best_val_accuracy == 1.0
    for k, v in _weights(result.best_state.model).items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(_weights(result.state.model)["cls.weight"], before["cls.weight"])
    # promoted best states are snapshots: equal to what was saved at promotion
    ck = Checkpointer(str(tmp_path / "ck"))
    result = _fit(_state(cfg), splits, cfg, epochs=3, checkpointer=ck)
    saved = torch.load(ck.file("best"), weights_only=True)
    for k, v in _weights(result.best_state.model).items():
        assert torch.equal(v, saved["model"][k]), k
    latest = torch.load(ck.file("latest"), weights_only=True)
    assert latest["epoch"] == 3 and latest["best_acc"] == result.best_val_accuracy


def test_callbacks_and_grad_norms():
    cfg = _cfg("default_urfall", batch_size=16)
    splits = _splits(cfg, n=96)
    steps = splits["train"].n // 16
    epochs, per_step = [], []
    _fit(_state(cfg), splits, cfg, epochs=2, grad_norms=True,
         metrics_callback=lambda e, s: epochs.append((e, s)),
         step_metrics_callback=lambda i, s: per_step.append((i, s)),
         lr_fn=lambda step: 1e-3)
    assert [e for e, _ in epochs] == [1, 2]
    assert set(epochs[0][1]) == {"train_loss", "train_accuracy", "val_loss", "val_accuracy", "lr"}
    assert [i for i, _ in per_step] == list(range(2 * steps))
    assert "grad_norm/cls.weight" in per_step[0][1]
    assert all(np.isfinite(v) and v >= 0 for v in per_step[0][1].values())


def test_scan_has_no_counterpart_yet():
    cfg = _cfg("default_urfall")
    with pytest.raises(ValueError, match="no counterpart"):
        make_train_epoch(impl="scan")
    with pytest.raises(ValueError, match="no counterpart"):
        _fit(_state(cfg), _splits(cfg, n=48), cfg, epochs=1, scan_epochs=True)


def test_zero_step_epoch_is_caught_by_the_nan_guard():
    cfg = _cfg("default_urfall", batch_size=64)
    result = _fit(_state(cfg), _splits(cfg, n=48), cfg, epochs=2)
    assert len(result.history["train_loss"]) == 1 and np.isnan(result.history["train_loss"][0])


def test_bfloat16_trains_under_autocast():
    cfg = _cfg("default_urfall", batch_size=16, dtype="bfloat16", epochs=2)
    result = run_fold(cfg, _splits(cfg, n=96), device="cpu")
    assert np.isfinite(result.history["train_loss"]).all()
    assert all(p.dtype == torch.float32 for p in result.state.model.parameters())


def test_augmentation_runs_inside_run_fold():
    cfg = _cfg("default_urfall", batch_size=16, epochs=2)
    cfg = cfg.replace(augment=dataclasses.replace(cfg.augment, enabled=True, rotate_deg=10,
                                                  flip_prob=0.5, joint_jitter=0.01))
    a = run_fold(cfg, _splits(cfg, n=96), device="cpu")
    b = run_fold(cfg, _splits(cfg, n=96), device="cpu")
    assert a.history["train_loss"] == b.history["train_loss"]      # seeded per epoch


# ------------------------------------------------------------ checkpoints

def test_checkpoint_round_trip_and_crash_inside_the_swap(tmp_path):
    cfg = _cfg("default_urfall", batch_size=16)
    splits = _splits(cfg, n=96)
    state = _state(cfg)
    state, _ = make_train_epoch(softmax_before_ce=False)(
        state, splits["train"], np.arange(32).reshape(2, 16))
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_latest(state, 4, 0.5)
    restored, epoch, best = ck.restore("latest", _state(cfg))
    assert (epoch, best, restored.step) == (4, 0.5, 2)
    for k, v in _weights(state.model).items():
        assert torch.equal(v, _weights(restored.model)[k]), k
    assert restored.optimizer.gradient_step == 2
    # a crash between moving the old checkpoint aside and the swap
    os.rename(ck._path("latest"), ck._path("latest.prev"))
    assert ck.has("latest")
    _, epoch, _ = ck.restore("latest", _state(cfg))
    assert epoch == 4
    # the file serves as a reference checkpoint
    sd = load_state_dict_file(ck.file("latest"))
    assert set(sd) == set(state.model.state_dict())


def test_run_fold_resumes_and_starts_from_pretrained(tmp_path):
    cfg = _cfg("default_urfall", batch_size=16)
    splits = _splits(cfg, n=96)
    ck = Checkpointer(str(tmp_path / "ck"))
    first = run_fold(cfg, splits, epochs=2, checkpointer=ck, device="cpu")
    resumed = run_fold(cfg, splits, epochs=3, resume_from=ck.directory, device="cpu")
    assert len(resumed.history["train_loss"]) == 1           # epoch 3 only
    full = run_fold(cfg, splits, epochs=3, device="cpu")
    np.testing.assert_allclose(resumed.history["train_loss"][0], full.history["train_loss"][2],
                               rtol=1e-5)
    assert resumed.best_val_accuracy >= first.best_val_accuracy
    for path in (ck.directory, ck.file("best")):
        warm = run_fold(cfg, splits, epochs=1, pretrained_path=path, device="cpu")
        assert len(warm.history["train_loss"]) == 1


def test_run_fold_refuses_splits_on_another_device():
    cfg = _cfg("default_urfall")
    with pytest.raises(ValueError, match="got splits on"):
        run_fold(cfg, _splits(cfg, n=48), device="meta")


# ------------------------------------------------------------------- CLI

def _cli(tmp_path, *extra, preset="gstcan_urfall_3stream"):
    return cli.main(["--config", preset, "--device", "cpu", "--set", "train.batch_size=8",
                     "--set", TINY_SET, "--synthetic-windows", "64",
                     "--output-dir", str(tmp_path / "run"), *extra])


def test_cli_writes_its_files_and_the_best_checkpoint_serves(tmp_path):
    out = _cli(tmp_path, "--epochs", "2")
    run = tmp_path / "run"
    for name in ("config.json", "history.json", "report.txt", "log.txt",
                 "ckpt/best/checkpoint.pt", "ckpt/latest/checkpoint.pt"):
        assert (run / name).exists(), name
    history = json.loads((run / "history.json").read_text())
    assert len(history["train_loss"]) == 2
    assert 0.0 <= out["test_accuracy"] <= 1.0 and "macro avg" in (run / "report.txt").read_text()
    # the best checkpoint through Predictor equals the trainer's eval forward
    cfg = _cfg()
    state = create_train_state(cfg, build_optimizer(cfg), device="cpu")
    Checkpointer(str(run / "ckpt")).restore("best", state)
    rng = np.random.default_rng(0)
    skel = rng.uniform(-1, 1, size=(6, 30, 14, 3)).astype(np.float32)
    sens = rng.normal(size=(6, 30, 4)).astype(np.float32)
    pred = Predictor.from_torch_checkpoint(cfg, str(run / "ckpt/best/checkpoint.pt"),
                                           batch_size=4, device="cpu")
    with torch.no_grad():
        ref = state.model.eval()(t(skel), t(sens))
    np.testing.assert_allclose(pred.predict_logits(skel, sens), to_numpy(ref), atol=2e-5)


def test_cli_resume_continues_at_the_saved_epoch(tmp_path):
    _cli(tmp_path, "--epochs", "1")
    _cli(tmp_path, "--epochs", "2", "--resume", str(tmp_path / "run" / "ckpt"))
    history = json.loads((tmp_path / "run" / "history.json").read_text())
    assert len(history["train_loss"]) == 1
    assert "resumed from" in (tmp_path / "run" / "log.txt").read_text()
    latest = torch.load(Checkpointer(str(tmp_path / "run" / "ckpt")).file("latest"),
                        weights_only=True)
    assert latest["epoch"] == 2


def test_cli_test_only_reads_best(tmp_path):
    _cli(tmp_path, "--epochs", "1")
    (tmp_path / "run" / "report.txt").unlink()
    out = _cli(tmp_path, "--test-only")
    assert set(out) == {"test_accuracy"}
    assert (tmp_path / "run" / "report.txt").exists()
    assert "restored best (epoch 1" in (tmp_path / "run" / "log.txt").read_text()


def test_cli_rejects_bad_input(tmp_path):
    with pytest.raises(SystemExit, match="epochs"):
        _cli(tmp_path, "--epochs", "0")
    with pytest.raises(SystemExit, match="override"):
        _cli(tmp_path, "--set", "optim.nope=1")
    with pytest.raises(SystemExit, match="single-split path only"):
        cli.main(["--config", "default_urfall", "--device", "cpu", "--cv", "--test-only"])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    cfg = _cfg("default_urfall")
    splits = _splits(cfg, n=48)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", "default_urfall", "--output-dir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fold(cfg, splits)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(cfg, build_optimizer(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device(make_synthetic(n_windows=4, seed=0))
    assert not (tmp_path / "x").exists()
    assert isinstance(build_optimizer(cfg), Optimizer)
