"""Kernel K3's CPU side (``ops/temporal_transformer.py``): the packed plain
version against ``TemporalTransformer``, the shape rule that decides where
a TARGCN ``Predictor`` serves its transformer through the kernel's module,
the packed path of a CPU ``Predictor`` against the model's own forward, its
spans, and the export of a TARGCN, which keeps the stock modules. The
kernel itself runs on the card only (``tests/test_torch_cuda.py``)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.models.init import seeded_model
from fall_multimodal_tpu_torch.models.targcn import TemporalTransformer
from fall_multimodal_tpu_torch.ops.temporal_transformer import (
    MAX_T,
    FusedTemporalTransformer,
    fused_temporal_transformer,
    kernel_takes,
    layer_layout,
    pack_temporal_transformer,
    temporal_transformer_reference,
)
from fall_multimodal_tpu_torch.serve import Predictor, export_pt2, load_pt2

torch.set_num_threads(1)

# the repository's module tolerance (PARITY.md); the packed version sums the
# convolutions in another order than the stock Conv2d
TOL = 2e-5


def _targcn(**kwargs):
    return load_config(preset_path("targcn_harup"),
                       overrides={f"model.kwargs.{k}": v for k, v in kwargs.items()})


def _perturbed(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module.eval()


def _windows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 30, 14, 3)).astype(np.float32)


@pytest.mark.parametrize("t,v,f,source", [
    (30, 14, 64, "targcn_harup"),       # the published widths, the preset's seeded weights
    (30, 14, 64, "drawn"),
    (7, 3, 16, "drawn"),                # a small width
    (32, 2, 8, "drawn"),                # every padded frame in use
])
def test_packed_plain_version_equals_the_temporal_transformer(t, v, f, source):
    if source == "targcn_harup":
        module = seeded_model(_targcn()).encoder.trans_layer_T.eval()
    else:
        torch.manual_seed(t + f)
        module = _perturbed(TemporalTransformer(f, 2, t), t)
    x = torch.from_numpy(np.random.default_rng(f).normal(size=(3, t, v, f)).astype(np.float32))
    packed = pack_temporal_transformer(module)
    launches = fused_temporal_transformer.launches
    with torch.no_grad():
        want = module(x)
        got = fused_temporal_transformer(x, packed)
    assert fused_temporal_transformer.launches == launches      # the CPU launches nothing
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
    torch.testing.assert_close(temporal_transformer_reference(x, packed), got, rtol=0, atol=0)
    # the pads the kernel reads stay zero: frames past T, columns past each row
    layout, floats = layer_layout(f)
    for i in range(2):
        layer = packed.weights[i * floats: (i + 1) * floats]
        for name in ("wq", "wk"):
            off, (rows, ld) = layout[name]
            block = layer[off: off + rows * ld].view(rows, ld)
            assert not block[t:].any() and not block[:, 3 * MAX_T:].any()
            assert not block[:, :3 * MAX_T].view(rows, 3, MAX_T)[:, :, t:].any()
        off, (rows, ld) = layout["bq"]
        assert not layer[off + t: off + ld].any()


@pytest.mark.parametrize("kwargs,frames,packed", [
    ({}, 30, True),                                     # the preset: T 30, F 64
    ({"rnn_units": 8, "embed_dim": 4}, 30, False),      # width 8: stock modules
    ({"rnn_units": 32}, 30, False),                     # width 32
    ({}, 33, False),                                    # more frames than the kernel pads to
    ({"gcn_variant": "linear"}, 16, True),              # any graph-GRU variant, fewer frames
])
def test_the_shape_rule_packs_what_the_kernel_takes(kwargs, frames, packed):
    cfg = _targcn(**kwargs)
    if frames != cfg.data.seq_len:
        cfg = load_config(preset_path("targcn_harup"), overrides={
            "data.seq_len": frames, **{f"model.kwargs.{k}": v for k, v in kwargs.items()}})
    pred = Predictor(cfg, seeded_model(cfg).state_dict(), batch_size=2, device="cpu")
    assert kernel_takes(pred.model.encoder.trans_layer_T) is packed
    served = pred.served.encoder.trans_layer_T
    assert isinstance(served, FusedTemporalTransformer) is packed
    assert (served is pred.model.encoder.trans_layer_T) is not packed
    skel = np.random.default_rng(1).normal(size=(3, frames, 14, 3)).astype(np.float32)
    with torch.no_grad():
        want = pred.model(torch.from_numpy(skel)).numpy()
    np.testing.assert_allclose(pred.predict_logits(skel), want, rtol=0, atol=TOL)


def test_the_kernel_takes_at_most_two_layers():
    assert kernel_takes(TemporalTransformer(64, 2, 30))
    assert kernel_takes(TemporalTransformer(64, 1, 32))
    assert not kernel_takes(TemporalTransformer(64, 3, 30))


def test_a_cpu_targcn_predictor_takes_the_packed_path():
    cfg = _targcn()
    pred = Predictor(cfg, seeded_model(cfg, seed=3).state_dict(), batch_size=4, device="cpu")
    ta = pred.served.encoder.trans_layer_T
    assert isinstance(ta, FusedTemporalTransformer) and ta.packed.weights.device.type == "cpu"
    skel = _windows(6, seed=2)                          # two chunks, the second padded
    calls = []
    real = pred.model.encoder.trans_layer_T.forward
    pred.model.encoder.trans_layer_T.forward = lambda x: calls.append(1) or real(x)
    try:
        got = pred.predict_logits(skel)
    finally:
        del pred.model.encoder.trans_layer_T.forward
    assert not calls                                    # the stock module never ran
    with torch.no_grad():
        want = pred.model(torch.from_numpy(skel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert pred.with_batch_size(1).served is pred.served
    np.testing.assert_allclose(pred.with_batch_size(1).predict_logits(skel[:1]), want[:1],
                               rtol=0, atol=TOL)


def test_the_packed_path_keeps_the_targcn_spans(tmp_path):
    cfg = _targcn()
    pred = Predictor(cfg, seeded_model(cfg).state_dict(), batch_size=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.predict_logits(_windows(2))
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["name"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(("targcn.", "predict.launch")))
    assert [s[1] for s in spans] == ["predict.launch", "targcn.recurrence", "targcn.recurrence",
                                     "targcn.transformer", "targcn.head"]
    launch = spans[0]
    assert all(launch[0] <= s[0] and s[2] <= launch[2] for s in spans[1:])


def test_a_targcn_still_exports_with_the_stock_modules():
    cfg = _targcn()
    model = seeded_model(cfg, seed=4)
    skel = _windows(2, seed=5)
    sens = np.zeros((2, 1, 1), np.float32)
    forward = load_pt2(export_pt2(cfg, model.state_dict(), skel.shape, sens.shape,
                                  device="cpu"))
    got = forward(torch.from_numpy(skel), torch.from_numpy(sens))
    with torch.no_grad():
        want = model(torch.from_numpy(skel))
    assert float((got - want).abs().max()) == 0.0
    pred = Predictor(cfg, model.state_dict(), batch_size=2, device="cpu")
    np.testing.assert_allclose(got.numpy(), pred.predict_logits(skel), rtol=0, atol=TOL)
