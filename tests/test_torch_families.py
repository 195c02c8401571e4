"""The model families beside the flagship (``stgcan``/``stgcn``,
``two_stgcan``, ``two_stgcan_bilstm``, ``bilstm``, ``cnn_bilstm``) against
their JAX modules, and the single-stream ``stgcan`` serving path against the
JAX ``Predictor``.

Weights are seeded (numpy), scaled like a trained network, made as JAX
variables and carried over by ``state_dict_from_jax_variables``. Modules are
compared at 2e-5, the JAX package's own parity tolerance for modules: two
float32 CPU implementations that sum in different orders. The STGCAN
families run narrow stage plans here, except the ``stgcan`` serving path,
which runs the full plan of ``default_urfall`` and is compared at 5e-5 like
the flagship's.
"""

import dataclasses
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.configs import load_config as jax_load_config
from fall_multimodal_tpu.configs import preset_path as jax_preset_path
from fall_multimodal_tpu.models import build_model as jax_build_model
from fall_multimodal_tpu.serve import Predictor as JaxPredictor
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.interop import (
    load_into,
    load_state_dict_file,
    normalize_reference_keys,
    state_dict_from_jax_variables,
)
from fall_multimodal_tpu_torch.models import (
    STGCANClassifier,
    TwoStreamSTGCAN,
    build_model,
    model_names,
    uses_sensor,
)
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import WholeBackbone, fused_backbone_forward
from fall_multimodal_tpu_torch.ops.stgcan_block import fused_stgcan_block
from fall_multimodal_tpu_torch.serve import (
    Predictor,
    StreamingClassifier,
    main,
    measure_push_latency,
)
from fall_multimodal_tpu_torch.server import PredictionServer
from torch_port_helpers import random_init, t, to_numpy

torch.set_num_threads(1)

NARROW = ((16, 1, False), (16, 1, True), (32, 2, True))
# id -> (preset, model name override, narrow stage plan?)
FAMILIES = {
    "stgcan": ("default_urfall", None, True),
    "stgcn": ("default", "stgcn", True),
    "two_stgcan": ("twostream_stgcan", None, True),
    "two_stgcan_bilstm": ("two_stgcan_bilstm_urfall", None, True),
    "gstcan_harup_bilstm": ("gstcan_harup_3stream", None, True),
    "bilstm": ("bilstm", None, False),
    "bilstm_urfall": ("bilstm_urfall", None, False),
    "cnn_bilstm": ("sensor_cnn_bilstm_urfall", None, False),
}


def _configs(preset, name=None, narrow=False):
    """The same preset, read by each package from its own copy."""
    out = []
    for load, path in ((jax_load_config, jax_preset_path), (load_config, preset_path)):
        cfg = load(path(preset))
        kwargs = dict(cfg.model.kwargs, **({"stages": NARROW} if narrow else {}))
        out.append(cfg.replace(model=dataclasses.replace(
            cfg.model, name=name or cfg.model.name, kwargs=kwargs)))
    return out


def _carry(preset, name=None, narrow=False, seed=3, n=5):
    jcfg, cfg = _configs(preset, name, narrow)
    rng = np.random.default_rng(seed)
    d = cfg.data
    skel = rng.normal(size=(n, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sensor = rng.normal(size=(n, d.seq_len, d.sensor_dim)).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    variables = random_init(jmodel, rng, jnp.asarray(skel[:2]), jnp.asarray(sensor[:2]),
                            train=False)
    return jcfg, cfg, jmodel, variables, skel, sensor


def test_registry_lists_the_families():
    from fall_multimodal_tpu.models import model_names as jax_model_names
    from fall_multimodal_tpu.models import uses_sensor as jax_uses_sensor

    assert set(model_names()) == {"stgcan", "stgcn", "two_stgcan", "two_stgcan_bilstm",
                                  "gstcan_3stream", "bilstm", "cnn_bilstm", "musa",
                                  "musa_ablation", "targcn", "skeleton_transformer",
                                  "skeleton_transformer_factorized", "transformer_ensemble"}
    assert set(model_names()) == set(jax_model_names())
    assert all(uses_sensor(n) == jax_uses_sensor(n) for n in model_names())
    assert not any(uses_sensor(n) for n in ("stgcan", "stgcn", "two_stgcan", "musa",
                                            "targcn", "skeleton_transformer"))
    assert all(uses_sensor(n) for n in ("two_stgcan_bilstm", "gstcan_3stream", "bilstm",
                                        "cnn_bilstm", "transformer_ensemble"))


# the Gen-3 and Gen-1 families' presets (their models: tests/test_torch_gen3_models.py)
GEN3_PRESETS = ("musa_harup", "musa_ablation_harup", "musa_fukinect", "musa_imvia",
                "targcn_harup", "skeleton_transformer_harup", "transformer_ensemble_harup")


@pytest.mark.parametrize("preset", sorted({p for p, _, _ in FAMILIES.values()}
                                          | set(GEN3_PRESETS)))
def test_preset_copies_are_in_step(preset):
    with open(jax_preset_path(preset)) as a, open(preset_path(preset)) as b:
        assert a.read() == b.read()
    assert jax_load_config(jax_preset_path(preset)).to_dict() == \
        load_config(preset_path(preset)).to_dict()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_matches_jax_module(family):
    jcfg, cfg, jmodel, variables, skel, sensor = _carry(*FAMILIES[family])
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(skel), jnp.asarray(sensor),
                                  train=False))
    sd = state_dict_from_jax_variables(cfg, variables)
    model = load_into(build_model(cfg), sd).eval()
    assert list(sd) == list(model.state_dict())
    with torch.no_grad():
        ours = model(t(skel), t(sensor))
    assert ours.shape == (len(skel), cfg.data.num_classes)
    assert np.ptp(ref, axis=0).min() > 1e-3          # the windows are told apart
    np.testing.assert_allclose(to_numpy(ours), ref, atol=2e-5)
    # the Predictor's path (folded backbones) gives the module's answer
    pred = Predictor(cfg, sd, batch_size=4, device="cpu")
    out = pred.predict_logits(skel, sensor if pred.requires_sensor else None)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert fused_backbone_forward.launches == 0 and fused_stgcan_block.launches == 0


def test_single_stream_keys_sit_at_the_root():
    _, cfg = _configs("default_urfall", narrow=True)
    model = build_model(cfg)
    assert isinstance(model, STGCANClassifier)
    keys = set(model.state_dict())
    assert {"A", "data_bn.weight", "st_gcn_networks.0.gcn.conv.weight", "edge_importance.2",
            "cls.weight", "cls.bias"} <= keys
    assert model.state_dict()["cls.weight"].shape == (2, 32, 1, 1)
    assert isinstance(build_model(_configs("twostream_stgcan", narrow=True)[1]),
                      TwoStreamSTGCAN)


def test_jax_variables_missing_or_extra_leaves_are_refused():
    _, cfg, _, variables, _, _ = _carry("default_urfall", narrow=True)
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((2, 2))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="not consumed: stray.kernel"):
        state_dict_from_jax_variables(cfg, extra)
    missing = {"params": {"STGCANBackbone_0": {
        k: v for k, v in variables["params"]["STGCANBackbone_0"].items() if k != "cls"}},
        "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="cls.kernel"):
        state_dict_from_jax_variables(cfg, missing)


# ------------------------------------------------- Gen-2 key spellings

def _gen2(sd, single_stream):
    """The same weights as the packaged Gen-2 code would have saved them."""
    out = {}
    for key, value in sd.items():
        key = key.replace("st_gcn_networks.", "st_gcan_networks.")
        for new, old in (("pts_stream.", "stgcan_1."), ("mot_stream.", "stgcan_2."),
                         ("sensor.", "lstm."), ("fcn.", "fc.")):
            if key.startswith(new):
                key = old + key[len(new):]
        out[key] = value
    if single_stream:           # notebook StreamSpatialTemporalGraph: an fcn Linear head
        out["fcn.weight"] = out.pop("cls.weight")[:, :, 0, 0]
        out["fcn.bias"] = out.pop("cls.bias")
    return out


@pytest.mark.parametrize("family", ["stgcan", "two_stgcan", "two_stgcan_bilstm"])
@pytest.mark.parametrize("suffix,wrap", [(".pt", None), (".pth", "state_dict"), (".npz", None)])
def test_gen2_spelled_checkpoint_loads_to_the_same_logits(tmp_path, family, suffix, wrap):
    _, cfg, _, variables, skel, sensor = _carry(*FAMILIES[family])
    sd = state_dict_from_jax_variables(cfg, variables)
    gen2 = _gen2(sd, single_stream=family == "stgcan")
    assert set(gen2) != set(sd)
    path = str(tmp_path / f"best_model{suffix}")
    if suffix == ".npz":
        np.savez(path, **gen2)
    else:
        tensors = {k: torch.as_tensor(v) for k, v in gen2.items()}
        torch.save(tensors if wrap is None else {wrap: tensors, "epoch": 1}, path)
    back = load_state_dict_file(path)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    sens = sensor if uses_sensor(cfg.model.name) else None
    want = Predictor(cfg, sd, batch_size=4, device="cpu").predict_logits(skel, sens)
    got = Predictor.from_torch_checkpoint(cfg, path, batch_size=4,
                                          device="cpu").predict_logits(skel, sens)
    np.testing.assert_array_equal(got, want)


def test_normalize_keeps_notebook_keys_and_refuses_double_spellings():
    _, cfg, _, variables, _, _ = _carry(*FAMILIES["two_stgcan_bilstm"])
    sd = state_dict_from_jax_variables(cfg, variables)
    assert list(normalize_reference_keys(sd)) == list(sd)
    both = dict(sd)
    both["fc.weight"] = sd["fcn.weight"]
    with pytest.raises(ValueError, match="two spellings"):
        normalize_reference_keys(both)
    # a sensor-only BiLSTM's own ``fc.1`` and ``lstm1`` are not Gen-2 prefixes
    _, bcfg, _, bvars, _, _ = _carry(*FAMILIES["bilstm"])
    bsd = state_dict_from_jax_variables(bcfg, bvars)
    assert {"fc.1.weight", "lstm1.weight_ih_l0"} <= set(bsd)
    assert list(normalize_reference_keys(bsd)) == list(bsd)
    # an unknown key passes through and fails where the model is loaded
    stray = normalize_reference_keys(dict(sd, **{"stgcan_3.data_bn.weight": np.zeros(3)}))
    with pytest.raises(ValueError, match=r"unused stgcan_3\.data_bn\.weight"):
        load_into(build_model(cfg), stray)


# ------------------------------------- the stgcan serving path, full width

@pytest.fixture(scope="module")
def stgcan_served():
    jcfg, cfg, _, variables, skel, sensor = _carry("default_urfall", n=6, seed=9)
    sd = state_dict_from_jax_variables(cfg, variables)
    return jcfg, variables, cfg, sd, skel, sensor, Predictor(cfg, sd, batch_size=4,
                                                             device="cpu")


def test_stgcan_predictor_matches_jax_predictor(stgcan_served):
    jcfg, variables, cfg, sd, skel, sensor, pred = stgcan_served
    assert not pred.requires_sensor and isinstance(pred.served, WholeBackbone)
    ref = JaxPredictor(jcfg, variables, batch_size=4).predict_logits(skel)   # pad + chunk
    assert np.ptp(ref, axis=0).min() > 0.05
    np.testing.assert_allclose(pred.predict_logits(skel), ref, atol=5e-5)
    # the sensor stream is ignored, given or not
    np.testing.assert_array_equal(pred.predict_logits(skel, sensor), pred.predict_logits(skel))
    assert fused_backbone_forward.launches == 0


@pytest.mark.parametrize("n", [0, 1, 3, 4, 6])
def test_stgcan_ragged_batches_match_the_module(stgcan_served, n):
    *_, skel, _, pred = stgcan_served
    out = pred.predict_logits(skel[:n])
    assert out.shape == (n, 2) and out.dtype == np.float32
    if n:
        with torch.no_grad():
            ref = pred.model(t(skel[:n]))
        np.testing.assert_allclose(out, to_numpy(ref), atol=2e-5)
        assert pred.predict(skel[:n]).tolist() == to_numpy(ref).argmax(-1).tolist()
        np.testing.assert_allclose(pred.predict_proba(skel[:n]).sum(-1), 1, atol=1e-6)


def test_stgcan_sensor_count_mismatch_is_refused(stgcan_served):
    *_, skel, sensor, pred = stgcan_served
    with pytest.raises(ValueError, match="counts must match"):
        pred.predict_logits(skel, sensor[:2])


def test_stgcan_streaming_takes_no_sensor(stgcan_served):
    *_, skel, sensor, pred = stgcan_served
    stream = StreamingClassifier(pred, seq_len=30)
    frames = np.concatenate([skel[0], skel[1][:2]])
    decisions = [stream.push(f) for f in frames]
    assert decisions[:29] == [None] * 29
    for end in (30, 31, 32):
        assert decisions[end - 1] == pred.predict(frames[None, end - 30:end])[0]
    with pytest.raises(ValueError, match="earlier pushes omitted"):
        stream.push(frames[0], sensor[0][0])
    stats = measure_push_latency(StreamingClassifier(pred), n_pushes=2, warmup=1)
    assert stats["n"] == 2 and 0 < stats["p50_ms"] <= stats["p99_ms"]


def test_server_answers_a_request_without_a_sensor(stgcan_served):
    *_, skel, sensor, pred = stgcan_served
    srv = PredictionServer(pred, host="127.0.0.1", port=0).start()

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/predict",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["model"] == "stgcan"
        assert health["requires_sensor"] is False and health["num_classes"] == 2
        want = pred.predict_proba(skel)
        out = post({"skeleton": skel.tolist(), "proba": True})
        assert out["n"] == len(skel) and out["predictions"] == want.argmax(-1).tolist()
        np.testing.assert_allclose(np.asarray(out["probabilities"]), want, atol=1e-6)
        # a sensor that is sent along is dropped, and one window may come bare
        assert post({"skeleton": skel.tolist(),
                     "sensor": sensor.tolist()})["predictions"] == out["predictions"]
        assert post({"skeleton": skel[0].tolist()})["predictions"] == out["predictions"][:1]
    finally:
        srv.close()


@pytest.fixture
def stgcan_checkpoint(stgcan_served, tmp_path):
    *_, sd, _, _, _ = stgcan_served
    path = str(tmp_path / "stgcan.npz")
    np.savez(path, **sd)
    return path


def test_cli_predict_and_latency_on_stgcan(stgcan_served, stgcan_checkpoint, tmp_path, capsys):
    *_, skel, _, pred = stgcan_served
    np.savez(tmp_path / "in.npz", skeleton=skel)
    out = tmp_path / "pred.csv"
    res = main(["predict", "--config", "default_urfall", "--checkpoint", stgcan_checkpoint,
                "--input", str(tmp_path / "in.npz"), "--output", str(out),
                "--batch-size", "4", "--device", "cpu"])
    assert res["n"] == len(skel)
    with open(out) as fh:
        rows = fh.read().split()[1:]
    assert [int(r.split(",")[1]) for r in rows] == pred.predict(skel).tolist()
    stats = main(["latency", "--config", "default_urfall", "--checkpoint", stgcan_checkpoint,
                  "--device", "cpu", "--pushes", "2"])
    assert stats["n"] == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n"] == 2


def test_cli_serve_warms_up_without_a_sensor(stgcan_checkpoint, monkeypatch):
    from fall_multimodal_tpu_torch import server

    served = {}

    class FakeServer:
        host, port = "127.0.0.1", 0

        def __init__(self, predictor, **kw):
            served["predictor"] = predictor

        def serve(self):
            served["served"] = True

    monkeypatch.setattr(server, "make_server", FakeServer)
    main(["serve", "--config", "default_urfall", "--checkpoint", stgcan_checkpoint,
          "--device", "cpu", "--batch-size", "2"])
    assert served["served"] and not served["predictor"].requires_sensor


@pytest.mark.parametrize("preset", ["default_urfall", "default", "twostream_stgcan", "bilstm",
                                    "sensor_cnn_bilstm_urfall"])
def test_predictor_without_device_needs_a_card(monkeypatch, preset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(load_config(preset_path(preset)), {})
