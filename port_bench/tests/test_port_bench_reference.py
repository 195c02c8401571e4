"""The plain references against the system under test at small sizes on
the CPU, from one seeded state_dict: the single-stream STGCAN classifier,
the 3-stream GSTCAN with its CNN-BiLSTM, and the RMSprop train step with
the softmax before the cross entropy. (The tests may import the system;
the references may not.)"""

import json
import os

import numpy as np
import pytest
import torch

from port_bench.harness import checks, core, data
from port_bench.harness.weights import seed_weights
from port_bench.reference import gstcan3, rmsprop_step, stgcan

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [[16, 1, False], [16, 1, True], [32, 2, True], [32, 1, True]]


def _config(name, **model):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg["model"].update(stages=SMALL, **model)
    return cfg


def _inputs(cfg, n, seed):
    m = cfg["model"]
    w = data.make_windows(n, m["seq_len"], m["num_joints"], m["num_classes"],
                          m["sensor_dim"] if m["uses_sensor"] else 0, 0.15, seed)
    sensor = None if w.sensor is None else torch.from_numpy(w.sensor)
    return torch.from_numpy(w.pose), sensor, torch.from_numpy(w.labels)


def test_adjacency_equals_the_systems():
    from fall_multimodal_tpu_torch.graphs import build_adjacency

    np.testing.assert_array_equal(stgcan.spatial_adjacency(),
                                  build_adjacency("coco_cut", "spatial"))


@pytest.mark.parametrize("name,family", [("stgcan_harup", stgcan),
                                          ("gstcan_urfall_3stream", gstcan3)])
def test_eval_logits_equal_the_systems(name, family):
    from fall_multimodal_tpu_torch.interop import load_into
    from fall_multimodal_tpu_torch.models import build_model
    from fall_multimodal_tpu_torch.serve import Predictor

    cfg = _config(name)
    pose, sensor, _ = _inputs(cfg, 12, seed=3)
    ref = family.build(cfg["model"])
    sd = seed_weights(ref, 2 ** 31 + 7, "trained", condition=(pose, sensor))
    with torch.no_grad():
        want = ref.eval()(pose, sensor).numpy()
    port_cfg = core.port_config(cfg)
    plain = load_into(build_model(port_cfg), sd).eval()
    with torch.no_grad():
        got = plain(pose, sensor if sensor is not None else torch.zeros(12, 1, 1)).numpy()
    assert checks.logit_gap(got, want) < 1e-5
    served = Predictor(port_cfg, sd, batch_size=8, device="cpu").predict_logits(
        pose.numpy(), None if sensor is None else sensor.numpy())
    assert checks.logit_gap(served, want) < 1e-5
    assert np.abs(want).max() > 0.1          # the conditioned weights give real logits


def test_train_steps_equal_the_systems():
    from fall_multimodal_tpu_torch.train.loop import make_train_step
    from fall_multimodal_tpu_torch.data.pipeline import DeviceData
    from fall_multimodal_tpu_torch.train.optim import build_optimizer
    from fall_multimodal_tpu_torch.train.state import create_train_state

    cfg = _config("gstcan_urfall_3stream")
    port_cfg = core.port_config(cfg)
    ref = gstcan3.build(cfg["model"])
    sd = seed_weights(ref, 11, "init")
    state = create_train_state(port_cfg, build_optimizer(port_cfg), seed=0, device="cpu")
    state.model.load_state_dict(sd)
    trainer = rmsprop_step.Trainer(ref, cfg["optim"], cfg["train"], softmax_output=True)
    step = make_train_step(softmax_before_ce=True)
    pose, sensor, labels = _inputs(cfg, 24, seed=5)
    losses_p, losses_r = [], []
    for i in range(3):
        rows = slice(8 * i, 8 * i + 8)
        _, m = step(state, DeviceData(pose[rows], labels[rows], sensor[rows]))
        loss, grads = trainer.step(pose[rows], sensor[rows], labels[rows])
        losses_p.append(float(m["loss"]))
        losses_r.append(loss)
        if i == 0:
            alpha = cfg["optim"]["rms_decay"]
            named = dict(state.model.named_parameters())
            got = {n: float(torch.sqrt(state.optimizer.inner.state[p]["square_avg"].sum()
                                       / (1 - alpha))) for n, p in named.items()}
            want = {n: float(g.norm()) for n, g in grads.items()}
            # float32 sums in another order move a cancelling leaf's norm by
            # up to a few 1e-4 of the median leaf's (CPU, 1-8 threads)
            assert checks.norm_gap(got, want)[0] < 1e-3
            stats_p = {k: v for k, v in state.model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
            stats_r = {k: v for k, v in ref.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
            assert checks.value_gap(stats_p, stats_r)[0] < 1e-5
    assert abs(losses_p[0] - losses_r[0]) < 1e-6 * abs(losses_r[0])
    # later steps: RMSprop moves noise-level gradients by +-10 lr, so the
    # two sides part slightly (the benchmark's limits cover that)
    assert checks.relative_gap(losses_p, losses_r) < 1e-3


class _Linear(torch.nn.Linear):
    def forward(self, x, sensor=None):
        return super().forward(x)


def test_the_reference_trainer_clips_and_updates_as_torch_rmsprop():
    torch.manual_seed(0)
    model, twin = _Linear(3, 2), torch.nn.Linear(3, 2)
    twin.load_state_dict(model.state_dict())
    trainer = rmsprop_step.Trainer(
        model, {"type": "rmsprop", "lr": 1e-2, "rms_decay": 0.99, "eps": 1e-8},
        {"max_norm": 0.5}, softmax_output=False, loss_fn=lambda out, t: (out * t).sum())
    opt = torch.optim.RMSprop(twin.parameters(), lr=1e-2, alpha=0.99, eps=1e-8)
    x, t = torch.randn(4, 3), 10 * torch.randn(4, 2)
    for _ in range(3):
        trainer.step(x, None, t)
        opt.zero_grad()
        (twin(x) * t).sum().backward()
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in twin.parameters()))
        assert norm >= 0.5                       # the clip is exercised
        for p in twin.parameters():
            p.grad.mul_(0.5 / norm)
        opt.step()
    for a, b in zip(model.parameters(), twin.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
