"""The port's serving leftovers against the JAX package's ``serve.py``, on the
CPU: ``Predictor.from_checkpoint`` on the trainer's checkpoint directories
(``best``, ``latest``, the ``.prev`` fallback), ``strict=False``, the serving
CLI's ``--checkpoint <dir> --which`` with ``.npy``/``.npz``/pickle input,
export to ``.pt2`` and back, and the JAX-checkpoint converter
(``experiments/convert_jax_checkpoint.py``)."""

import dataclasses
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch

from fall_multimodal_tpu import serve as jax_serve
from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu_torch import serve
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.models.init import seeded_model
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
from fall_multimodal_tpu_torch.serve import Predictor, export_pt2, load_pt2
from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state
from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ((16, 1, False), (16, 1, True), (32, 2, True))


def _cfg(preset="gstcan_urfall_3stream", **kwargs):
    cfg = load_config(preset_path(preset))
    if preset in ("gstcan_urfall_3stream", "default_urfall"):
        kwargs = {"stages": TINY, **kwargs}
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 kwargs={**cfg.model.kwargs, **kwargs}))


def _config_file(cfg, tmp_path):
    """``cfg`` as a run's ``config.json``, which both packages load."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg.to_dict(), default=str))
    return str(path)


def _windows(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    d = cfg.data
    return (rng.normal(size=(n, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32),
            rng.normal(size=(n, d.seq_len, d.sensor_dim)).astype(np.float32))


def _state(cfg, seed):
    state = create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed, device="cpu")
    state.model.load_state_dict(seeded_model(cfg, seed).state_dict())
    return state


# ------------------------------------------------------- checkpoint dirs

def test_from_checkpoint_serves_best_latest_and_the_prev_copy(tmp_path):
    cfg = _cfg()
    skel, sens = _windows(cfg)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    best, latest = _state(cfg, 1), _state(cfg, 2)
    ck.save_best(best, 3, 0.75)
    ck.save_latest(latest, 4, 0.75)
    want = {name: Predictor(cfg, st.model.state_dict(), batch_size=4,
                            device="cpu").predict_logits(skel, sens)
            for name, st in (("best", best), ("latest", latest))}
    assert np.abs(want["best"] - want["latest"]).max() > 1e-3
    for which in ("best", "latest"):
        got = Predictor.from_checkpoint(cfg, str(tmp_path / "ckpt"), which=which,
                                        batch_size=4, device="cpu")
        np.testing.assert_array_equal(got.predict_logits(skel, sens), want[which])
        assert got.device == torch.device("cpu")
        assert isinstance(got.served.pts_stream, FusedBackbone)
    # a crash inside the swap leaves only best.prev: it is served
    os.rename(tmp_path / "ckpt" / "best", tmp_path / "ckpt" / "best.prev")
    got = Predictor.from_checkpoint(cfg, str(tmp_path / "ckpt"), batch_size=4, device="cpu")
    np.testing.assert_array_equal(got.predict_logits(skel, sens), want["best"])


def test_from_checkpoint_refuses_what_it_cannot_serve(tmp_path, monkeypatch):
    cfg = _cfg()
    missing = tmp_path / "none"
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        Predictor.from_checkpoint(cfg, str(missing), device="cpu")
    assert not missing.exists()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="holds no 'best'"):
        Predictor.from_checkpoint(cfg, str(tmp_path / "empty"), device="cpu")
    with pytest.raises(ValueError, match="which="):
        Predictor.from_checkpoint(cfg, str(tmp_path / "empty"), which="last", device="cpu")
    # a directory is not a reason to serve on the CPU: no card, no device -> raise
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save_best(_state(cfg, 1), 1, 0.5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint(cfg, str(tmp_path / "ckpt"))


# ------------------------------------------------------------- strict

def test_strict_false_ignores_unused_keys_as_the_jax_package_does(tmp_path):
    cfg = _cfg()
    jcfg = jax_load_config(_config_file(cfg, tmp_path))
    skel, sens = _windows(cfg)
    sd = {k: v.numpy() for k, v in seeded_model(cfg, 3).state_dict().items()}
    extra = tmp_path / "extra.npz"
    np.savez(extra, **sd, **{"aux_head.weight": np.ones((3, 3), np.float32)})
    for strict_call in (lambda: Predictor.from_torch_checkpoint(cfg, str(extra), device="cpu"),
                        lambda: jax_serve.Predictor.from_torch_checkpoint(jcfg, str(extra))):
        with pytest.raises(ValueError, match="aux_head"):
            strict_call()
    ours = Predictor.from_torch_checkpoint(cfg, str(extra), strict=False, batch_size=4,
                                           device="cpu").predict_logits(skel, sens)
    ref = jax_serve.Predictor.from_torch_checkpoint(jcfg, str(extra), strict=False,
                                                    batch_size=4).predict_logits(skel, sens)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)
    # a missing or mis-shaped key is an error with strict=False too, in both
    name = "fcn.weight"
    for label, bad in (("missing", {k: v for k, v in sd.items() if k != name}),
                       ("misshaped", {**sd, name: sd[name][:, :-1]})):
        path = tmp_path / f"{label}.npz"
        np.savez(path, **bad)
        with pytest.raises(ValueError, match="fcn"):
            Predictor.from_torch_checkpoint(cfg, str(path), strict=False, device="cpu")
        with pytest.raises((ValueError, KeyError), match="fcn|Dense_0"):
            jax_serve.Predictor.from_torch_checkpoint(jcfg, str(path), strict=False)


# ------------------------------------------------------------ the CLI

def _fold_checkpoint(cfg, tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt" / "fold0"))
    ck.save_best(_state(cfg, 4), 2, 0.5)
    ck.save_latest(_state(cfg, 5), 3, 0.5)
    return str(tmp_path / "ckpt" / "fold0")


def _predictions(path):
    with open(path) as fh:
        rows = [line.strip().split(",") for line in fh][1:]
    return np.asarray([[float(x) for x in row[1:]] for row in rows])


def test_predict_cli_serves_a_fold_from_npy_npz_and_pickle(tmp_path):
    cfg = _cfg("default_urfall")
    config = _config_file(cfg, tmp_path)
    fold = _fold_checkpoint(cfg, tmp_path)
    skel, _ = _windows(cfg, n=7)
    np.save(tmp_path / "x.npy", skel)
    np.savez(tmp_path / "x.npz", skeleton=skel)
    with open(tmp_path / "x.pkl", "wb") as fh:
        pickle.dump((np.arange(7), skel, np.eye(2, dtype=np.float32)[np.arange(7) % 2]), fh)
    outs = []
    for name in ("x.npy", "x.npz", "x.pkl"):
        out = str(tmp_path / f"{name}.csv")
        res = serve.main(["predict", "--config", config, "--checkpoint", fold, "--which",
                          "best", "--input", str(tmp_path / name), "--output", out,
                          "--proba", "--device", "cpu", "--batch-size", "4"])
        assert res["n"] == 7
        outs.append(_predictions(out))
    for other in outs[1:]:
        np.testing.assert_array_equal(outs[0], other)
    proba = Predictor.from_checkpoint(cfg, fold, batch_size=4, device="cpu").predict_proba(skel)
    np.testing.assert_allclose(outs[0][:, 1:], proba, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(outs[0][:, 0], proba.argmax(-1))
    latest = str(tmp_path / "latest.csv")
    serve.main(["predict", "--config", config, "--checkpoint", fold, "--which", "latest",
                "--input", str(tmp_path / "x.npy"), "--output", latest, "--proba",
                "--device", "cpu"])
    assert np.abs(_predictions(latest)[:, 1:] - outs[0][:, 1:]).max() > 1e-4


def test_predict_cli_refuses_sensorless_input_with_the_jax_message(tmp_path):
    cfg = _cfg()
    skel, _ = _windows(cfg)
    np.save(tmp_path / "x.npy", skel)
    msgs = []
    for main in (serve.main, jax_serve.main):
        with pytest.raises(SystemExit) as exc:
            main(["predict", "--config", "gstcan_urfall_3stream", "--checkpoint",
                  str(tmp_path / "ckpt"), "--input", str(tmp_path / "x.npy")])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "consumes the sensor stream" in msgs[0]


# ------------------------------------------------------------- export

@pytest.mark.parametrize("preset", ["gstcan_urfall_3stream", "musa_harup"])
def test_export_round_trip_is_exact_on_the_cpu(tmp_path, preset):
    cfg = _cfg(preset) if preset != "musa_harup" else _cfg(preset, embed_dim=16, n_stage=1)
    model = seeded_model(cfg, 6)
    skel, sens = _windows(cfg, n=5)
    blob = export_pt2(cfg, model.state_dict(), skel.shape, sens.shape, device="cpu")
    forward = load_pt2(blob)
    x, s = torch.from_numpy(skel), torch.from_numpy(sens)
    got = forward(x, s)
    with torch.no_grad():
        want = model(x, s)
    assert float((got - want).abs().max()) == 0.0
    pred = Predictor(cfg, model.state_dict(), batch_size=5, device="cpu")
    np.testing.assert_allclose(got.numpy(), pred.predict_logits(
        skel, sens if pred.requires_sensor else None), rtol=0, atol=1e-5)
    # the CLI's export of a checkpoint dir loads to the same program
    ck = Checkpointer(str(tmp_path / "ckpt"))
    state = create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed, device="cpu")
    state.model.load_state_dict(model.state_dict())
    ck.save_best(state, 1, 0.5)
    out = str(tmp_path / "m.pt2")
    res = serve.main(["export", "--config", _config_file(cfg, tmp_path), "--checkpoint",
                      str(tmp_path / "ckpt"), "--output", out, "--batch-size", "5",
                      "--device", "cpu"])
    with open(out, "rb") as fh:
        assert res["bytes"] == len(fh.read())
        fh.seek(0)
        assert float((load_pt2(fh.read())(x, s) - want).abs().max()) == 0.0


# ---------------------------------------------------------- converter

def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", os.path.join(ROOT, "experiments", "convert_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_checkpoint_converts_and_serves_within_2e5(tmp_path):
    import jax
    import jax.numpy as jnp

    from fall_multimodal_tpu.models import build_model as jax_build_model
    from fall_multimodal_tpu.train.optim import build_optimizer as jax_build_optimizer
    from fall_multimodal_tpu.train.state import create_train_state as jax_create_train_state
    from fall_multimodal_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer

    cfg = _cfg()
    config = _config_file(cfg, tmp_path)
    jcfg = jax_load_config(config)
    skel, sens = _windows(cfg, n=6)
    state = jax_create_train_state(jax_build_model(jcfg), jax_build_optimizer(jcfg),
                                   jnp.asarray(skel[:2]), jnp.asarray(sens[:2]), seed=7)
    # non-trivial batch statistics, as a trained network's
    rng = np.random.default_rng(8)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray((1 + 0.3 * rng.random(x.shape)) if p[-1].key == "var"
                                 else 0.1 * rng.normal(size=x.shape), x.dtype),
        state.batch_stats)
    state = state._replace(batch_stats=stats)
    JaxCheckpointer(str(tmp_path / "jax_ckpt")).save_best(state, 1, 0.5)
    out = str(tmp_path / "w.npz")
    _converter().main(["--config", config, "--checkpoint", str(tmp_path / "jax_ckpt"),
                       "--output", out])
    ours = Predictor.from_torch_checkpoint(cfg, out, batch_size=4,
                                           device="cpu").predict_logits(skel, sens)
    ref = jax_serve.Predictor.from_checkpoint(jcfg, str(tmp_path / "jax_ckpt"), skel, sens,
                                              batch_size=4).predict_logits(skel, sens)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)
