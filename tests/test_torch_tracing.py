"""The port's spans and counters on the CPU (``utils/profiling.py:span``):
under a running ``torch.profiler`` a serving call, a per-epoch ``fit`` with
a checkpointer, a fused ``fit``, a TARGCN serving call and a musa train
step put each of their spans into the exported chrome trace under its
parent; with no profiler running ``span`` hands out one shared no-op
context and nothing is recorded; the counters count ``predict_logits``
calls, train steps, the frames TARGCN's graph-GRU layers step through and
the branches musa's DropGraph masks."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import make_synthetic, split_dataset, to_device
from fall_multimodal_tpu_torch.data.pipeline import DeviceData, gather_batch
from fall_multimodal_tpu_torch.models.init import seeded_model
from fall_multimodal_tpu_torch.models.musa import _DropGraphBlock
from fall_multimodal_tpu_torch.models.targcn import GraphGRUCell
from fall_multimodal_tpu_torch.serve import Predictor
from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state, fit
from fall_multimodal_tpu_torch.train.loop import make_train_epoch, make_train_step
from fall_multimodal_tpu_torch.utils import profiling
from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)

TINY = ((16, 1, False), (16, 1, True), (32, 2, True))
PARENT = {
    "predict_logits": None, "predict.prep": "predict_logits", "predict.h2d": "predict_logits",
    "predict.launch": "predict_logits", "predict.d2h": "predict_logits",
    "fit.epoch": None, "fit.shuffle": "fit.epoch", "fit.train": "fit.epoch",
    "fit.eval": "fit.epoch", "fit.read": "fit.epoch", "fit.snapshot": ("fit.epoch", None),
    "fit.chunk": None, "train.step": ("fit.train", "fit.chunk"), "step.gather": "train.step",
    "step.forward": "train.step", "step.backward": "train.step", "step.optimizer": "train.step",
    "checkpoint.save": "fit.epoch", "checkpoint.serialize": "checkpoint.save",
    "checkpoint.swap": "checkpoint.save",
    "targcn.recurrence": "predict.launch", "targcn.transformer": "predict.launch",
    "targcn.head": "predict.launch",
}
# a musa train step's spans, each directly inside the step's forward
MUSA_PARENT = dict.fromkeys(("musa.graph", "musa.temporal", "musa.dropgraph"), "step.forward")


def _flagship(**train):
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, kwargs=dict(cfg.model.kwargs, stages=TINY)),
        train=dataclasses.replace(cfg.train, batch_size=16, **train))


def _splits(cfg, n=96):
    d = cfg.data
    data = make_synthetic(n_windows=n, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          noise=0.05, windows_per_video=8, seed=0)
    return {k: to_device(v, "cpu")
            for k, v in split_dataset(data, split=(0.7, 0.15, 0.15), seed=1).items()}


def _fit(cfg, epochs, **kw):
    state = create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed, device="cpu")
    return fit(state, _splits(cfg), epochs=epochs, batch_size=cfg.train.batch_size,
               num_classes=cfg.data.num_classes, softmax_before_ce=cfg.model.softmax_output,
               shuffle_seed=cfg.seed, **kw)


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 30, 14, 3)).astype(np.float32),
            rng.normal(size=(n, 30, 4)).astype(np.float32))


def _port_spans(tmp_path, work, known=PARENT):
    """``(name, start, end)`` of every port span in the chrome trace of a
    CPU profiler around ``work()``, and each one's innermost enclosing port
    span (None at the top); ``known`` names the port spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"] in known), key=lambda s: (s[1], -s[2]))
    parents = []
    for name, s, e in spans:
        around = [o for o in spans if o[1] <= s and e <= o[2] and o != (name, s, e)]
        parents.append(min(around, key=lambda o: o[2] - o[1])[0] if around else None)
    return spans, parents


def _assert_nested(spans, parents):
    for (name, _, _), parent in zip(spans, parents):
        want = PARENT[name]
        assert parent in (want if isinstance(want, tuple) else (want,)), (name, parent)


@pytest.fixture(scope="module")
def predictor():
    cfg = _flagship()
    state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
    return Predictor(cfg, state.model.state_dict(), batch_size=4, device="cpu")


@pytest.fixture(scope="module")
def targcn_predictor():
    cfg = load_config(preset_path("targcn_harup"),
                      overrides={"model.kwargs.rnn_units": 8, "model.kwargs.embed_dim": 4})
    return Predictor(cfg, seeded_model(cfg, seed=0).state_dict(), batch_size=4, device="cpu")


def test_a_serving_call_puts_its_spans_under_predict_logits(tmp_path, predictor):
    skel, sens = _windows(6)                    # two chunks, the second padded
    out = {}
    spans, parents = _port_spans(tmp_path, lambda: out.update(
        got=predictor.predict_logits(skel, sens)))
    names = [s[0] for s in spans]
    assert names.count("predict_logits") == 1
    for child in ("predict.prep", "predict.h2d", "predict.launch", "predict.d2h"):
        assert names.count(child) == 2, names
    _assert_nested(spans, parents)
    np.testing.assert_array_equal(out["got"], predictor.predict_logits(skel, sens))


def test_a_targcn_forward_puts_its_spans_inside_predict_launch(tmp_path, targcn_predictor):
    pose = _windows(4)[0]
    spans, parents = _port_spans(tmp_path, lambda: targcn_predictor.predict_logits(pose))
    names = [s[0] for s in spans]
    assert names.count("predict.launch") == 1
    assert names.count("targcn.recurrence") == 2            # one per graph-GRU layer
    assert names.count("targcn.transformer") == names.count("targcn.head") == 1
    _assert_nested(spans, parents)
    order = [n for n in names if n.startswith("targcn.")]
    assert order == ["targcn.recurrence", "targcn.recurrence", "targcn.transformer",
                     "targcn.head"]


def test_the_targcn_step_counter_counts_every_layers_frames(targcn_predictor):
    steps = GraphGRUCell.steps
    targcn_predictor.predict_logits(_windows(4)[0])
    assert GraphGRUCell.steps - steps == 60                 # 30 frames x 2 layers
    targcn_predictor.predict_logits(_windows(9)[0])         # three chunks, three forwards
    assert GraphGRUCell.steps - steps == 60 * 4


def test_targcn_logits_are_the_same_with_and_without_a_profiler(targcn_predictor):
    poses = _windows(4, seed=3)[0]
    plain = targcn_predictor.predict_logits(poses)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = targcn_predictor.predict_logits(poses)
    np.testing.assert_array_equal(traced, plain)


def test_a_per_epoch_fit_with_a_checkpointer_puts_its_spans_under_their_parents(tmp_path):
    cfg = _flagship()
    steps_before = make_train_step.steps
    ckpt = Checkpointer(os.path.join(tmp_path, "ckpt"))
    spans, parents = _port_spans(tmp_path, lambda: _fit(cfg, 2, checkpointer=ckpt))
    names = [s[0] for s in spans]
    assert names.count("fit.epoch") == 2
    for name in ("fit.shuffle", "fit.train", "fit.eval", "fit.read"):
        assert names.count(name) == 2, (name, names)
    assert names.count("fit.snapshot") >= 1
    steps = make_train_step.steps - steps_before
    assert steps > 0 and names.count("train.step") == steps
    for name in ("step.gather", "step.forward", "step.backward", "step.optimizer"):
        assert names.count(name) == steps, name
    saves = names.count("checkpoint.save")
    assert saves >= 3                            # a latest per epoch, a best at least once
    assert names.count("checkpoint.serialize") == names.count("checkpoint.swap") == saves
    assert "fit.chunk" not in names
    _assert_nested(spans, parents)


def test_a_fused_fit_nests_the_step_spans_in_its_chunk(tmp_path):
    cfg = _flagship()
    spans, parents = _port_spans(tmp_path, lambda: _fit(cfg, 2, epoch_impl="scan",
                                                         scan_epochs=True))
    names = [s[0] for s in spans]
    assert names.count("fit.chunk") == 1 and "fit.epoch" not in names
    assert names.count("train.step") > 0
    for name in ("step.gather", "step.forward", "step.backward", "step.optimizer"):
        assert names.count(name) == names.count("train.step"), name
    assert set(parents[names.index("train.step"):]) <= {"fit.chunk", "train.step"}
    _assert_nested(spans, parents)


def test_a_serving_call_and_both_fits_record_every_span(tmp_path, predictor, targcn_predictor):
    cfg = _flagship()
    seen = set()
    for work in (lambda: predictor.predict_logits(*_windows(4)),
                 lambda: targcn_predictor.predict_logits(_windows(4)[0]),
                 lambda: _fit(cfg, 2, checkpointer=Checkpointer(str(tmp_path / "c"))),
                 lambda: _fit(cfg, 1, epoch_impl="scan", scan_epochs=True)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            work()
        seen |= {e.key for e in prof.key_averages()}
    assert set(PARENT) <= seen


def test_without_a_profiler_span_is_one_shared_no_op(tmp_path, predictor):
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("predict.prep"), profiling.span("fit.epoch")
    assert a is b
    with a as entered:
        assert entered is None
    predictor.predict_logits(*_windows(4))      # no profiler: nothing is kept
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not {e.key for e in prof.key_averages()} & set(PARENT)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("predict.prep"), torch.profiler.record_function)


def test_the_counters_count_calls_and_steps(predictor):
    calls = Predictor.calls
    predictor.predict_logits(*_windows(9))      # three chunks, one call
    predictor.predict_logits(*_windows(1))
    assert Predictor.calls - calls == 2
    cfg = _flagship()
    state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
    data = _splits(cfg)["train"]
    idx = np.arange(3 * 16).reshape(3, 16) % data.n
    steps = make_train_step.steps
    make_train_epoch(softmax_before_ce=cfg.model.softmax_output)(state, data, idx)
    assert make_train_step.steps - steps == 3 == state.step
    step = make_train_step(softmax_before_ce=cfg.model.softmax_output)
    step(state, gather_batch(data, torch.as_tensor(idx[0])))
    assert make_train_step.steps - steps == 4


def _musa_state():
    cfg = load_config(preset_path("musa_harup"), overrides={"model.kwargs.embed_dim": 8})
    state = create_train_state(cfg, build_optimizer(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(4)
    batch = DeviceData(torch.from_numpy(rng.normal(size=(4, 30, 14, 3)).astype(np.float32)),
                       torch.eye(11)[torch.arange(4)], torch.zeros(4, 1, 1))
    return state, batch


def test_a_musa_train_step_records_its_spans_with_none_inside_another(tmp_path):
    state, batch = _musa_state()
    step = make_train_step()
    spans, parents = _port_spans(tmp_path, lambda: step(state, batch),
                                 known={**PARENT, **MUSA_PARENT})
    names = [s[0] for s in spans]
    # per stream: the graph conv; two separable blocks and the SepTCN tail;
    # DropGraph of the graph conv's and both separable blocks' two branches
    assert names.count("musa.graph") == 2
    assert names.count("musa.temporal") == 6
    assert names.count("musa.dropgraph") == 6
    for (name, _, _), parent in zip(spans, parents):
        if name in MUSA_PARENT:
            assert parent == MUSA_PARENT[name], (name, parent)


def test_the_dropgraph_counter_counts_twelve_branches_a_train_forward_and_none_in_eval():
    state, batch = _musa_state()
    draws = _DropGraphBlock.draws
    make_train_step()(state, batch)
    assert _DropGraphBlock.draws - draws == 12            # 3 blocks x 2 branches x 2 streams
    state.model.eval()
    with torch.no_grad():
        state.model(batch.features)
    assert _DropGraphBlock.draws - draws == 12


def test_without_a_profiler_a_musa_train_step_records_nothing():
    state, batch = _musa_state()
    assert not torch.autograd._profiler_enabled()
    make_train_step()(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not {e.key for e in prof.key_averages()} & set(MUSA_PARENT)
