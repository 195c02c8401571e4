"""The port's data parallelism (``parallel/mesh.py``, ``mesh=`` through
``fit`` / ``run_fold`` and the CLI's ``--mesh`` / ``--distributed``) on the
CPU over gloo: two processes at one global batch against one process (curves
and final parameters at 1e-5: the same sums, split across two ranks), a
world of 1, and the mesh's own rules.

The two-process cases train ``bilstm`` under its preset's RMSprop and a
narrow flagship under SGD: RMSprop's first update is +-10 lr whatever a
gradient's size, so the flagship's BatchNorm-cancelled biases, whose
gradient is float noise, would move with unrelated signs in any two
summation orders (``tests/test_torch_train_parity.py``); SGD moves them by
lr times that noise. At lr 0.02 twelve SGD steps keep the two runs' float
noise under 1e-5 in every weight (at 0.05 it grows to 3e-5 in a temporal
conv's weights while the curves still agree).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fall_multimodal_tpu_torch import cli
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import make_synthetic, split_dataset, to_device
from fall_multimodal_tpu_torch.parallel import (
    make_mesh,
    make_parallel_eval_epoch,
    make_parallel_train_epoch,
    make_parallel_train_step,
    shard_data,
)
from fall_multimodal_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    make_eval_epoch,
    make_train_epoch,
    make_train_step,
)
from fall_multimodal_tpu_torch.train.cv import run_fold
from fall_multimodal_tpu_torch.utils.profiling import Throughput

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "bilstm": ("bilstm", {"data.num_classes": 3, "data.sensor_dim": 6,
                          "model.kwargs.hidden_size": 8, "train.batch_size": 16}),
    "flagship_sgd": ("gstcan_urfall_3stream", {
        "model.kwargs.stages": "[[8,1,false],[8,1,true],[16,2,true]]",
        "train.batch_size": 8, "optim.type": "sgd", "optim.lr": 0.02,
        "augment.enabled": True, "augment.rotate_deg": 10.0, "augment.sensor_noise": 0.1}),
}
CURVES = ("train_loss", "train_acc", "val_loss", "val_acc")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train(case, mesh=None, epochs=2):
    preset, overrides = CASES[case]
    cfg = load_config(preset_path(preset), overrides=overrides)
    d = cfg.data
    data = make_synthetic(n_windows=80, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          seed=3)
    splits = {k: to_device(v, "cpu") for k, v in split_dataset(data, seed=cfg.seed).items()}
    result = run_fold(cfg, splits, epochs=epochs, device="cpu", mesh=mesh)
    return result, splits


def _worker(rank, world, port, out):
    """One rank of a two-process gloo world: each case trained on the mesh;
    rank 0 saves the curves and the final weights."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(world, device="cpu")
        saved = {"rank": mesh.rank, "size": mesh.size}
        for case in CASES:
            result, splits = _train(case, mesh)
            saved[case] = {"history": {k: result.history[k] for k in CURVES},
                           "state": result.state.model.state_dict(),
                           "best_acc": result.best_val_accuracy,
                           "test_acc": result.test.accuracy}
        saved["shard"] = shard_data(splits["train"], mesh).features[:, 0, 0, 0]
        torch.save(saved, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ddp") / "rank")
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(2, _free_port(), out), nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two-process run did not finish in 240 s")
    return [torch.load(f"{out}.{r}", weights_only=False) for r in (0, 1)]


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_train_as_one_at_the_same_global_batch(two_ranks, case):
    ours, _ = _train(case)
    for rank in two_ranks:
        got = rank[case]
        for k in CURVES:
            np.testing.assert_allclose(got["history"][k], ours.history[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        for name, t in ours.state.model.state_dict().items():
            np.testing.assert_allclose(got["state"][name].numpy(), t.numpy(), atol=1e-5,
                                       err_msg=name)
        assert got["best_acc"] == ours.best_val_accuracy
        assert got["test_acc"] == ours.test.accuracy
    assert [r["rank"] for r in two_ranks] == [0, 1] and two_ranks[0]["size"] == 2


def test_shard_data_gives_each_rank_its_own_contiguous_share(two_ranks):
    _, splits = _train("flagship_sgd", epochs=1)
    whole = splits["train"].features[:, 0, 0, 0]
    half = whole.shape[0] // 2
    np.testing.assert_array_equal(two_ranks[0]["shard"].numpy(), whole[:half].numpy())
    np.testing.assert_array_equal(two_ranks[1]["shard"].numpy(), whole[half:2 * half].numpy())


def test_cli_under_torchrun_trains_as_one_process_and_only_rank_0_writes(tmp_path):
    args = ["--config", "bilstm", "--device", "cpu", "--epochs", "2", "--synthetic-windows",
            "96", "--set", "data.num_classes=3", "--set", "model.kwargs.hidden_size=8"]
    cli.main([*args, "--output-dir", str(tmp_path / "one")])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         "-m", "fall_multimodal_tpu_torch.cli", *args, "--distributed", "--mesh", "2",
         "--output-dir", str(tmp_path / "two")],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-3000:]
    with open(tmp_path / "one" / "history.json") as fh:
        one = json.load(fh)
    with open(tmp_path / "two" / "history.json") as fh:
        two = json.load(fh)
    for k in CURVES:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert run.stdout.count("torch.distributed initialized: 2 process(es)") == 2
    with open(tmp_path / "two" / "log.txt") as fh:
        log = fh.read()
    assert log.count("best val accuracy") == 1          # rank 0's log only
    assert "windows/s" in log and "per card" in log      # Throughput over the mesh
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one"))


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_a_world_of_one_is_the_plain_run(world_of_one, tmp_path):
    mesh = world_of_one
    assert (mesh.size, mesh.rank, mesh.device.type, dist.get_backend()) == (1, 0, "cpu", "gloo")
    plain, _ = _train("bilstm", epochs=2)
    meshed, _ = _train("bilstm", mesh=mesh, epochs=2)
    assert plain.history["train_loss"] == meshed.history["train_loss"]
    assert plain.history["val_acc"] == meshed.history["val_acc"]
    args = ["--config", "bilstm", "--device", "cpu", "--epochs", "1", "--synthetic-windows",
            "64", "--set", "data.num_classes=3", "--output-dir", str(tmp_path)]
    trained = cli.main([*args, "--mesh", "1"])
    tested = cli.main([*args, "--test-only", "--mesh", "1"])
    assert tested["test_accuracy"] == trained["test_accuracy"]
    assert cli.main([*args, "--test-only"]) == tested


def test_the_parallel_epoch_functions_on_a_world_of_one(world_of_one):
    preset, overrides = CASES["bilstm"]
    cfg = load_config(preset_path(preset), overrides=overrides)
    data = to_device(make_synthetic(n_windows=64, num_classes=3, sensor_dim=6, seed=0), "cpu")
    idx = torch.arange(64).view(4, 16)
    mask = torch.ones(4, 16)
    plain, meshed = (create_train_state(cfg, build_optimizer(cfg), seed=1, device="cpu")
                     for _ in range(2))
    _, m_plain = make_train_epoch()(plain, data, idx)
    _, m_mesh = make_parallel_train_epoch(world_of_one)(meshed, data, idx)
    assert float(m_plain["loss"]) == float(m_mesh["loss"])
    batch = data._replace(features=data.features[:16], labels=data.labels[:16],
                          sensors=data.sensors[:16])
    assert float(make_train_step()(plain, batch)[1]["loss"]) == \
        float(make_parallel_train_step(world_of_one)(meshed, batch)[1]["loss"])
    for a, b in zip(make_eval_epoch(3)(plain, data, idx, mask),
                    make_parallel_eval_epoch(3, world_of_one)(meshed, data, idx, mask)):
        assert torch.equal(a, b)


def test_mesh_rules():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        make_mesh(1, axis="model", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    fold = make_mesh(3, axis="fold", device="cpu")
    assert (fold.size, fold.rank, fold.group) == (3, 0, None)
    assert not dist.is_initialized()


def test_throughput_counts_windows_per_card():
    tp = Throughput(n_devices=2)
    tp.update(64)
    time.sleep(0.01)
    tp.update(64)
    assert tp.windows_per_sec > 0
    assert tp.windows_per_sec_per_chip == pytest.approx(tp.windows_per_sec / 2, rel=1e-2)
    assert Throughput().n_devices == 1
