"""Serving surface of the port on the CPU: streaming classifier, latency
probe, HTTP server and CLI, each against the direct ``Predictor``."""

import csv
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.interop import load_state_dict_file
from fall_multimodal_tpu_torch.serve import (
    Predictor,
    StreamingClassifier,
    main,
    measure_push_latency,
)
from fall_multimodal_tpu_torch.server import PredictionServer

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "reference_gstcan3.npz")


@pytest.fixture(scope="module")
def predictor():
    sd = load_state_dict_file(FIX)
    return Predictor(load_config(preset_path("gstcan_urfall_3stream")), sd,
                     batch_size=4, device="cpu")


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 30, 14, 3)).astype(np.float32),
            rng.normal(size=(n, 30, 4)).astype(np.float32))


def test_streaming_classifies_the_trailing_window(predictor):
    rng = np.random.default_rng(1)
    poses = rng.normal(size=(33, 14, 3)).astype(np.float32)
    sens = rng.normal(size=(33, 4)).astype(np.float32)
    stream = StreamingClassifier(predictor, seq_len=30)
    assert stream.predictor.batch_size == 1
    decisions = [stream.push(p, s) for p, s in zip(poses, sens)]
    assert decisions[:29] == [None] * 29
    for end in range(30, 34):
        want = predictor.predict(poses[None, end - 30:end], sens[None, end - 30:end])[0]
        assert decisions[end - 1] == want
    with pytest.raises(ValueError, match="sensor_frame"):
        stream.push(poses[0])


def test_measure_push_latency_on_cpu(predictor):
    stats = measure_push_latency(StreamingClassifier(predictor), n_pushes=3, warmup=1,
                                 sensor_dim=4)
    assert stats["n"] == 3 and 0 < stats["p50_ms"] <= stats["p99_ms"]


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_server_matches_predictor(predictor):
    srv = PredictionServer(predictor, host="127.0.0.1", port=0).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["model"] == "gstcan_3stream"
        for n, seed in ((1, 2), (6, 3)):
            skel, sens = _windows(n, seed)
            out = _post(srv.port, {"skeleton": skel.tolist(), "sensor": sens.tolist(),
                                   "proba": True})
            want = predictor.predict_proba(skel, sens)
            assert out["n"] == n
            np.testing.assert_allclose(np.asarray(out["probabilities"]), want, atol=1e-6)
            assert out["predictions"] == want.argmax(-1).tolist()
    finally:
        srv.close()


def test_cli_predict_writes_the_predictor_output(predictor, tmp_path):
    skel, sens = _windows(5, 4)
    np.savez(tmp_path / "in.npz", skeleton=skel, sensor=sens)
    out = tmp_path / "pred.csv"
    main(["predict", "--config", "gstcan_urfall_3stream", "--checkpoint", FIX,
          "--input", str(tmp_path / "in.npz"), "--output", str(out), "--proba",
          "--batch-size", "4", "--device", "cpu"])
    with open(out) as fh:
        rows = list(csv.reader(fh))[1:]
    want = predictor.predict_proba(skel, sens)
    assert [int(r[1]) for r in rows] == want.argmax(-1).tolist()
    np.testing.assert_allclose([[float(v) for v in r[2:]] for r in rows], want, atol=1e-6)


@pytest.mark.parametrize("wrap", [None, "model", "state_dict"])
def test_pt_checkpoint_loads_like_the_npz(tmp_path, wrap):
    sd = load_state_dict_file(FIX)
    tensors = {k: torch.as_tensor(v) for k, v in sd.items()}
    tensors["sensor.cnn.fc.weight"] = torch.zeros(32, 224)      # dead reference head
    path = str(tmp_path / "best_model.pt")
    torch.save(tensors if wrap is None else {wrap: tensors, "epoch": 3}, path)
    back = load_state_dict_file(path)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])
