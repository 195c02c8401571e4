"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fall_multimodal_tpu_torch/ops/csrc``
and holds each against its plain PyTorch version at every shape its serving
path gives it: the STGCAN-block kernel at the flagship's 14 block shapes, the
whole-backbone kernel at the single-stream ``stgcan`` model's full width (2
and 11 classes) and on a short stage plan. Serves the reference checkpoint
and a seeded random flagship (``gstcan_urfall_3stream``, full widths, batch
128) through ``Predictor`` and the HTTP server, then a seeded ``stgcan``
(``default_urfall``; one whole-backbone launch per forward) and a
``two_stgcan`` the same way, and prints timings. The flagship is served once
under PyTorch's default TF32 switches before they are set for the plain
versions: served results are full float32 whatever the switches say. Each
kernel's time stands beside its bound on the pipe it uses (split TF32 on the
tensor cores), the older fp32-FMA bound, and the time of ``torch.matmul`` on
the tap GEMM alone (a yardstick the port never calls). Phase 7 trains: three
float32 steps of the full-width flagship on the card under the default TF32
switches against the same steps on the CPU; ``run_fold`` on synthetic data
for the flagship and for ``stgcan``, whose best checkpoints are then served
through ``Predictor`` (14 block-kernel launches, respectively one
whole-backbone launch) and held against the trainer's eval forward; and
train windows/s at batch 32 and 1024 in float32 and bfloat16 (and with the
dense graph conv off), printed as a ``{"train": [...]}`` line before the
kernel line. Phase 8 takes the Gen-3 and Gen-1 families (``musa``,
``musa_ablation``, ``targcn``, the two skeleton transformers, the
transformer ensemble), which run as plain modules: the four reference
fixtures served under PyTorch's default TF32 switches (8a); each family at
its preset's full width, batch 128, card against CPU, with windows/s and
push latency (8b); k-copies inference (``num_copies=2``) through the
kernels at T=15, held against the plain versions (8c); ``run_fold`` of
``musa_harup`` and ``targcn_harup`` served from their best checkpoints, and
train windows/s of three families (8d); printed as a ``{"families": [...]}``
line. Phase 9 runs the cross-validation path through the trainer's and the
server's CLIs in-process at full preset width: ``--cv`` of the flagship (3
folds x 2 epochs) and of ``stgcan`` (2 x 1) on 1,024 synthetic windows,
each fold's ``best`` directory served by ``Predictor.from_checkpoint``
through K1 (14 launches) / K2 (1) and held against the trainer's eval
forward; a ``musa_harup`` ``--grid``; a CSV tree read by the Gen-3 loader
through the native slicer, built here and held against the numpy slicer;
``serve predict`` from ``.npy``, ``.npz`` and pickle input; ``serve export``
of the flagship at batch 128, the loaded program against the Predictor
under the default TF32 flags; printed as a ``{"cv": [...]}`` line. Phase 10
takes fold-parallel CV and data parallelism, which reach no kernel (their
launch counts are read and printed): vmapped flagship steps of five folds
at full width against the CPU and against the single-fold step, their host
and device-busy ms beside the single-fold step's; ``cli.main
--cv-vmapped`` and ``--cv`` of the flagship (5 folds x 2 epochs) on 1,024
windows, ``--cv-vmapped --cv-mesh 1`` against the unsharded run,
``cnn_bilstm`` vmapped over 10 folds, ``run_fold`` through a world-size-1
NCCL mesh against the plain run; printed as a ``{"cv_parallel": ...}``
line. Phase 11 takes fused epochs: one fused chunk of the flagship under
``torch.cuda.set_sync_debug_mode("error")`` (no operation inside reads from
the card); ``fit`` of the flagship (batch 32, 1,024 windows, 4 epochs) and
of ``musa_harup`` (2 epochs) from one state per epoch, with
``scan_epochs=True`` and with chunks of 2, curves and every field of the
best and final states equal, windows/s of each; the fused best state served
through ``Predictor`` (14 block-kernel launches) against the trainer's eval
forward; the flagship's ``cross_validate_vmapped`` (5 folds x 2 epochs)
fused against per epoch; the blocks no preset builds, card against CPU;
printed as a ``{"fused": ...}`` line. Any failed check raises.
The second-to-last line is a JSON object describing each kernel; the last
line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from fall_multimodal_tpu_torch import cli as train_cli
from fall_multimodal_tpu_torch import serve as serve_cli
from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.data import (
    epoch_batch_indices,
    gather_batch,
    kfold_datasets,
    load_csv_windows,
    load_dataset,
    make_synthetic,
    split_dataset,
    to_device,
)
from fall_multimodal_tpu_torch.interop import load_into, load_state_dict_file
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.models.init import seeded_model
from fall_multimodal_tpu_torch.models.layers import GraphConv
from fall_multimodal_tpu_torch.ops import build
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import (
    fused_backbone_forward,
    fused_backbone_reference,
)
from fall_multimodal_tpu_torch.ops.stgcan_block import (
    fused_stgcan_block,
    kernel_smem_bytes,
    stgcan_block_emulated,
    stgcan_block_reference,
)
from fall_multimodal_tpu_torch.serve import (
    Predictor,
    StreamingClassifier,
    load_pt2,
    measure_push_latency,
)
from fall_multimodal_tpu_torch.server import PredictionServer
from fall_multimodal_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    fit,
    make_eval_epoch,
    make_train_epoch,
    make_train_step,
)
from fall_multimodal_tpu_torch.data.augment import make_augment_fn
from fall_multimodal_tpu_torch.parallel import make_mesh
from fall_multimodal_tpu_torch.train.cv import run_fold
from fall_multimodal_tpu_torch.train.cv_vmapped import (
    cross_validate_vmapped,
    fold_indices,
    load_fold,
    make_fold_train_step,
    stack_states,
)
from fall_multimodal_tpu_torch.train.loop import FusedEpochs
from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer
from fall_multimodal_tpu_torch.utils.device import full_float32

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "reference_gstcan3.npz")
BATCH = 128
SEED = 0
KERNEL_TOL = 1e-4        # split-TF32 kernel vs fp32 plain version, other summation order
MODEL_TOL = 1e-4
SHORT_PLAN = ((64, 1, False), (128, 2, True))
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 in them, HBM3 bandwidth. The kernels' GEMMs run in split
# TF32, three tensor-core products for one fp32 product; the adjacency
# contraction, the SE gate and the epilogues run as fp32 FMAs.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PRODUCTS = 3
PEAK_BYTES = 3.35e12
TRAIN_LOSS_RTOL = 1e-4   # card (split summation, cuDNN) vs CPU float32 train loss
TRAIN_WINDOWS = 16_384   # device-resident windows behind the training timings
FOLD_STEP_TOL = 1e-5     # vmapped fold vs the single-fold step: grouped vs plain cuDNN calls
CV_MESH_TOL = 1e-6       # --cv-mesh 1 vs the unsharded vmapped run: the same program
MESH_CURVE_TOL = 1e-5    # run_fold on a world-size-1 mesh vs plain, deterministic cuDNN
# stgcan push p50 minus the batch-1 kernel time in the run before the
# wrappers stopped checking every constant on every call (2.288 - 1.920 ms)
HOST_SHARE_BEFORE_MS = 0.368


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_cost(n, t, v, cin, folded, stride, mode):
    """(GEMM flops, other flops, bytes) one block call must do/move: the
    three GEMMs (channel mix, taps, residual projection), the rest (adjacency
    contraction over the nonzeros of this block's adjacency, SE MLP); each
    input and weight read once, the output written once."""
    k, c = folded.A.shape[0], folded.bn1_scale.shape[0]
    h = c // 4
    t_out = (t - 1) // stride + 1
    gemm = 2 * n * (t * v * k * cin * c             # channel mix
                    + t_out * v * 9 * c * c)        # temporal taps
    if mode == "proj":
        gemm += 2 * n * t_out * v * cin * c
    nnz = int((folded.A != 0).sum())
    other = 2 * n * (t * nnz * cin                  # adjacency contraction (sparse)
                     + 2 * c * h)                   # SE MLP
    weights = sum(x.numel() for x in folded if x is not None)
    nbytes = 4 * (n * t * v * cin + n * t_out * v * c + weights)
    return gemm, other, nbytes


def bounds_ms(gemm, other, nbytes):
    """(bound, bound_by, fp32-FMA bound) in ms: the least time for the
    GEMMs as three TF32 tensor-core products each plus the rest as fp32 FMAs,
    or for the bytes if that is larger; and what the same operations would
    need on the fp32 FMA pipe alone (the bound of the earlier kernels)."""
    ops_ms = (gemm * TF32_PRODUCTS / PEAK_TF32_FLOPS + other / PEAK_FP32_FLOPS) * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    fma_ms = max((gemm + other) / PEAK_FP32_FLOPS * 1e3, byte_ms)
    return max(ops_ms, byte_ms), "operations" if ops_ms >= byte_ms else "bytes", fma_ms


def tap_gemm_library_ms(n, t_out, v, c):
    """(fp32 ms, TF32 ms) of ``torch.matmul`` on a block's tap GEMM alone, as
    one (n * t_out * v, 9c) x (9c, c) product on rows already gathered: how
    far the hand-written GEMM is from cuBLAS on the same product."""
    a = torch.randn((n * t_out * v, 9 * c), device="cuda")
    b = torch.randn((9 * c, c), device="cuda")
    out = []
    saved = torch.backends.cuda.matmul.allow_tf32
    for allow in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = allow
        out.append(cuda_ms(lambda: torch.matmul(a, b)))
    torch.backends.cuda.matmul.allow_tf32 = saved
    return tuple(out)


def backbone_cost(n, t, v, cin, folded):
    """(GEMM flops, other flops, bytes) of one whole-backbone call: the blocks' operations by
    :func:`block_cost`'s count plus the pool and the head; x and every
    constant read once, the logits written once (activations between the
    blocks are not inputs or outputs of the function)."""
    gemm = other = 0
    weights = folded.data_bn_scale.numel() * 2 + folded.cls_w.numel() + folded.cls_b.numel()
    tt, cc = t, cin
    for block, (stride, mode) in zip(folded.blocks, folded.stage_plan):
        g, o, _ = block_cost(n, tt, v, cc, block, stride, mode)
        gemm, other = gemm + g, other + o
        weights += sum(x.numel() for x in block if x is not None)
        tt, cc = (tt - 1) // stride + 1, block.bn1_scale.shape[0]
    classes = folded.cls_b.shape[0]
    other += n * (2 * t * v * cin + tt * v * cc + 2 * cc * classes)   # data BN, pool, head
    return gemm, other, 4 * (n * t * v * cin + n * classes + weights)


def block_shapes(pred):
    """Every block call of one flagship forward: (stream, index, T, folded,
    stride, mode), following T through both streams."""
    d = pred.config.data
    calls = []
    for stream, fb, t in (("pts", pred.pts_fb, d.seq_len), ("mot", pred.mot_fb, d.seq_len - 1)):
        for i, (folded, stride, mode) in enumerate(fb.blocks):
            calls.append((stream, i, t, folded, stride, mode))
            t = (t - 1) // stride + 1
    return calls


def seeded_state_dict(cfg):
    """Random weights of ``cfg``'s model from SEED, with non-trivial BN
    statistics. Conv and linear weights are scaled from torch's default init
    to He's variance (2 / fan_in), so activations keep O(1) through the
    backbones."""
    torch.manual_seed(SEED)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if param.dim() >= 2 and "lstm" not in name:
                param.mul_(6 ** 0.5)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.3 * torch.rand(buf.shape, generator=gen))
    return model.state_dict()


def http_json(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


# ---- phase 7: training -------------------------------------------------------

def seeded_train_state(cfg, sd, device):
    """A train state on ``device`` holding the weights ``sd``."""
    state = create_train_state(cfg, build_optimizer(cfg), seed=SEED, device=device)
    load_into(state.model, sd)
    return state


def train_steps_card_vs_cpu(cfg, sd, dev, defaults):
    """Phase 7a: three batch-32 float32 steps of the full-width flagship on
    the card, under PyTorch's default TF32 switches, and on the CPU. Before
    each step the card takes the CPU's state (weights, running statistics,
    RMSprop's averages), so each step is compared from one state: its loss
    within TRAIN_LOSS_RTOL, its gradients and batch statistics printed. The
    same three steps run free on the card as well and are printed: RMSprop
    amplifies float differences of tiny gradients into parameter steps of up
    to lr, so free-running losses part after the first step. Fails on a
    loss, a non-finite value, or if the caller's switches changed."""
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    d = cfg.data
    data = make_synthetic(n_windows=96, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          seed=SEED)
    rows = np.random.default_rng(SEED).permutation(96).reshape(3, 32)
    step = make_train_step(softmax_before_ce=cfg.model.softmax_output)
    cpu_dev = torch.device("cpu")
    card, cpu, free = (seeded_train_state(cfg, sd, x) for x in (dev, cpu_dev, dev))
    split_card, split_cpu = to_device(data, dev), to_device(data, cpu_dev)
    out = {"loss_card": [], "loss_cpu": [], "loss_free_running": [], "loss_rel_err": [],
           "grad_rel_l2_err": [], "grad_max_abs_err": [], "grad_abs_max": [],
           "stats_max_abs_err": []}
    for row in rows:
        card.model.load_state_dict(cpu.model.state_dict())
        card.optimizer.load_state_dict(copy.deepcopy(cpu.optimizer.state_dict()))
        losses = []
        for state, split in ((card, split_card), (cpu, split_cpu), (free, split_card)):
            idx = torch.as_tensor(row, device=split.features.device)
            _, m = step(state, gather_batch(split, idx))
            losses.append(float(m["loss"]))
        g_card = {k: p.grad.detach().cpu() for k, p in card.model.named_parameters()}
        g_cpu = {k: p.grad for k, p in cpu.model.named_parameters()}
        s_card = {k: v.cpu() for k, v in card.model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))}
        s_cpu = cpu.model.state_dict()
        out["loss_card"].append(losses[0])
        out["loss_cpu"].append(losses[1])
        out["loss_free_running"].append(losses[2])
        out["loss_rel_err"].append(abs(losses[0] - losses[1]) / abs(losses[1]))
        out["grad_rel_l2_err"].append(
            (sum(float(((g_card[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
             / sum(float((g ** 2).sum()) for g in g_cpu.values())) ** 0.5)
        out["grad_max_abs_err"].append(max(float((g_card[k] - g_cpu[k]).abs().max())
                                           for k in g_cpu))
        out["grad_abs_max"].append(max(float(g.abs().max()) for g in g_cpu.values()))
        out["stats_max_abs_err"].append(max(float((v - s_cpu[k]).abs().max())
                                            for k, v in s_card.items()))
    after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"train 7a: flagship, batch 32, float32, 3 steps under the default flags {defaults}, "
        f"each from the CPU's state: loss card {out['loss_card']} cpu {out['loss_cpu']} "
        f"(rel err {out['loss_rel_err']}); grads relative L2 err {out['grad_rel_l2_err']}, "
        f"max abs err {out['grad_max_abs_err']} "
        f"(|grad| max {out['grad_abs_max']}); batch statistics max abs err "
        f"{out['stats_max_abs_err']}; free-running card losses {out['loss_free_running']}; "
        f"flags after {after}")
    if not max(out["loss_rel_err"]) <= TRAIN_LOSS_RTOL or after != defaults \
            or not np.isfinite(out["loss_card"]).all():
        raise AssertionError(f"card train steps disagree with the CPU ({out['loss_rel_err']}) "
                             f"or the caller's TF32 flags changed ({after})")
    return out


def train_then_serve(preset, epochs, dev, k1_per_forward, k2_per_forward):
    """Phases 7b and 8d: ``run_fold`` on 2,048 synthetic windows at full width, then
    the best checkpoint served on the card through ``Predictor``: launches
    counted over one batch-128 forward, logits held against the trainer's
    eval forward (plain modules, full float32) at MODEL_TOL."""
    cfg = load_config(preset_path(preset))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=epochs))
    d = cfg.data
    data = make_synthetic(n_windows=2048, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          seed=SEED)
    splits = {k: to_device(v, dev) for k, v in split_dataset(data, seed=cfg.seed).items()}
    ckpt_dir = os.path.join(ROOT, "outputs", "chip_smoke", preset)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    result = run_fold(cfg, splits, checkpointer=Checkpointer(ckpt_dir), device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    h = result.history
    log(f"train: {preset} run_fold, {splits['train'].n} train windows, batch "
        f"{cfg.train.batch_size}, {epochs} epochs in {fit_s:.2f} s: train loss {h['train_loss']}, "
        f"train acc {h['train_acc']}, val acc {h['val_acc']}, test acc "
        f"{result.test.accuracy:.4f}")
    best = Checkpointer(ckpt_dir).file("best")
    # a one-epoch run (targcn) is held to a finite loss only: one epoch of the
    # reference's init leaves it near chance
    learned = epochs == 1 or (h["train_loss"][-1] < h["train_loss"][0]
                              and h["train_acc"][-1] > 1.0 / d.num_classes)
    if not (np.isfinite(h["train_loss"]).all() and learned and os.path.exists(best)):
        raise AssertionError(f"{preset}: training did not learn or saved no best checkpoint")
    pred = Predictor.from_torch_checkpoint(cfg, best, batch_size=BATCH, device=dev)
    skel = data.features[:BATCH]
    sens = data.sensors[:BATCH]
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    logits = pred.predict_logits(skel, sens if pred.requires_sensor else None)
    launches = (fused_stgcan_block.launches, fused_backbone_forward.launches)
    model = result.best_state.model.eval()
    with torch.no_grad(), full_float32():
        ref = model(torch.from_numpy(skel).to(dev), torch.from_numpy(sens).to(dev)).cpu().numpy()
    err = float(np.abs(logits - ref).max())
    log(f"train: {preset} best checkpoint served: stgcan_block {launches[0]}, "
        f"fused_backbone {launches[1]} launches per batch-{BATCH} forward; logits vs the "
        f"trainer's eval forward max_abs_err={err:.3e} (|logits| max {np.abs(ref).max():.3f})")
    if launches != (k1_per_forward, k2_per_forward) or not err <= MODEL_TOL:
        raise AssertionError(f"{preset}: trained weights served through {launches} launches, "
                             f"off by {err}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"preset": preset, "epochs": epochs, "fit_s": fit_s, "train_loss": h["train_loss"],
            "train_acc": h["train_acc"], "val_acc": h["val_acc"],
            "test_acc": result.test.accuracy, "launches": list(launches), "max_abs_err": err}


def device_activity(fn, n):
    """(summed duration in ms, count) of the device activities (kernels,
    copies) of ``n`` calls of ``fn`` in a ``torch.profiler`` trace; (None, 0)
    when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA]
    return (sum(spans) / 1e3 if spans else None), len(spans)


def train_timing(cfg, data, batch, dtype, dev, card, steps):
    """Train windows/s of ``cfg`` at ``batch`` in ``dtype`` over
    device-resident windows: host ms per step (synchronised wall clock),
    CUDA-event ms per step, the profiler's device-busy ms per step, the
    device's share of the step, peak memory."""
    state = create_train_state(cfg, build_optimizer(cfg), seed=SEED, device=dev)
    epoch = make_train_epoch(softmax_before_ce=cfg.model.softmax_output,
                             compute_dtype=torch.bfloat16 if dtype == "bfloat16" else None)
    idx = epoch_batch_indices(torch.Generator(dev).manual_seed(SEED), data.n, batch)
    warm = idx[:3]
    one = idx[:1]
    epoch(state, data, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = idx[:steps]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    _, m = epoch(state, data, timed)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    event_ms = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated()
    n_prof = max(3, min(5, steps // 4))
    busy, activities = device_activity(lambda: epoch(state, data, one), n_prof)
    busy_ms = None if busy is None else busy / n_prof
    dense = next((m.dense_mode for m in state.model.modules() if isinstance(m, GraphConv)),
                 None)
    row = {"model": cfg.model.name, "dense_gcn": dense,
           "batch": batch, "dtype": dtype, "steps": steps,
           "windows_per_s": batch / host_ms * 1e3, "host_ms_per_step": host_ms,
           "event_ms_per_step": event_ms, "device_busy_ms_per_step": busy_ms,
           "device_activities_per_step": activities / n_prof,
           "device_share": None if busy_ms is None else busy_ms / host_ms,
           "max_memory_allocated_mb": peak / 2 ** 20, "loss": float(m["loss"]), "card": card}
    busy_txt = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms/step"
    share_txt = "not measured" if busy_ms is None else f"{row['device_share']:.3f}"
    log(f"train timing: {cfg.model.name} dense_gcn={row['dense_gcn']} batch {batch} {dtype}: "
        f"{row['windows_per_s']:.1f} windows/s, host {host_ms:.3f} ms/step, events "
        f"{event_ms:.3f} ms/step, device busy {busy_txt} (share {share_txt}, "
        f"{row['device_activities_per_step']:.0f} device activities a step), "
        f"peak {peak / 2 ** 20:.1f} MiB, loss {row['loss']:.4f} [{card}]")
    if not np.isfinite(row["loss"]):
        raise AssertionError(f"training timing run went non-finite: {row}")
    del state
    torch.cuda.empty_cache()
    return row


def train_timings(dev, card):
    """Phase 7c: flagship train windows/s at batch 32 (the preset) and 1024
    in float32 and bfloat16 on TRAIN_WINDOWS device-resident synthetic
    windows, and the float32 step with the dense graph conv switched off."""
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    d = cfg.data
    data = to_device(make_synthetic(n_windows=TRAIN_WINDOWS, num_classes=d.num_classes,
                                    sensor_dim=d.sensor_dim, seed=SEED), dev)
    factored = cfg.replace(model=dataclasses.replace(
        cfg.model, kwargs=dict(cfg.model.kwargs, dense_gcn=False)))
    rows = []
    for batch, steps in ((32, 40), (1024, 12)):
        for dtype in ("float32", "bfloat16"):
            rows.append(train_timing(cfg, data, batch, dtype, dev, card, steps))
        rows.append(train_timing(factored, data, batch, "float32", dev, card, steps))
    return rows


# ---- phase 8: the Gen-3 and Gen-1 families, k-copies ------------------------

FIXTURES = {   # name: (file, model kwargs, config overrides, input axes -> (N,[M,]T,V,C))
    "musa": ("reference_musa.npz", {"embed_dim": 16, "n_stage": 1, "act_type": "tanh",
                                    "block_size": 41, "edge": True, "bias": True},
             {"graph.strategy": "uniform"}, (0, 2, 3, 1)),
    "targcn": ("reference_targcn_full.npz", {"rnn_units": 8, "output_dim": 8, "horizon": 30,
                                             "num_layers": 2, "embed_dim": 4}, {}, None),
    "skeleton_transformer": ("reference_skeltrans.npz", {"embedding_dim": 16, "n_block": 2,
                                                         "head_dim": 4, "n_heads": 2},
                             {}, (0, 4, 2, 3, 1)),
    "skeleton_transformer_factorized": (
        "reference_skeltrans_ablation1.npz",
        {"embedding_dim": 16, "n_block": 2, "head_dim": 4, "n_heads": 2}, {}, (0, 4, 2, 3, 1)),
}
FAMILIES = (("musa", "musa_harup"), ("musa_ablation", "musa_ablation_harup"),
            ("targcn", "targcn_harup"), ("skeleton_transformer", "skeleton_transformer_harup"),
            ("skeleton_transformer_factorized", "skeleton_transformer_harup"),
            ("transformer_ensemble", "transformer_ensemble_harup"))


def family_config(name, preset):
    cfg = load_config(preset_path(preset))
    return cfg.replace(model=dataclasses.replace(cfg.model, name=name))


def serve_fixtures(dev, defaults):
    """Phase 8a: the four reference checkpoints of the new families served on
    the card through ``Predictor`` under PyTorch's default TF32 switches,
    within MODEL_TOL of the reference's own output."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    rows = []
    try:
        for name, (fname, kwargs, over, axes) in FIXTURES.items():
            cfg = load_config(preset_path("default"), overrides={
                "model.name": name, "data.num_classes": 11, "model.kwargs": kwargs, **over})
            path = os.path.join(ROOT, "tests", "fixtures", fname)
            pred = Predictor.from_torch_checkpoint(cfg, path, batch_size=8, device=dev)
            with np.load(path) as g:
                x = g["x"] if axes is None else np.transpose(g["x"], axes)
                out = g["out"]
            err = float(np.abs(pred.predict_logits(np.ascontiguousarray(x)) - out).max())
            log(f"8a: {name} reference checkpoint ({fname}) on the card, default TF32 flags "
                f"{defaults}: logits vs the reference's out max_abs_err={err:.3e}")
            if not err <= MODEL_TOL:
                raise AssertionError(f"{name}: reference checkpoint served off by {err}")
            rows.append({"family": name, "fixture": fname, "max_abs_err": err})
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        if after != defaults:
            raise AssertionError(f"serving changed the caller's TF32 flags: {after}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return rows


def serve_families(dev, rng):
    """Phase 8b: each family at its preset's full width, seeded weights,
    batch 128 on the card against the same Predictor on the CPU; no kernel
    launches (plain modules); device ms per forward, windows/s host to host,
    push p50/p99 at batch 1."""
    rows = []
    for name, preset in FAMILIES:
        cfg = family_config(name, preset)
        d = cfg.data
        sd = seeded_model(cfg, SEED).state_dict()
        skel = rng.normal(size=(BATCH, d.seq_len, d.num_joints, d.in_channels)).astype(
            np.float32)
        sens = rng.normal(size=(BATCH, d.seq_len, d.sensor_dim)).astype(np.float32)
        pred = Predictor(cfg, sd, batch_size=BATCH, device=dev)
        sens = sens if pred.requires_sensor else None
        fused_stgcan_block.launches = fused_backbone_forward.launches = 0
        logits = pred.predict_logits(skel, sens)
        launches = (fused_stgcan_block.launches, fused_backbone_forward.launches)
        cpu = Predictor(cfg, sd, batch_size=BATCH, device="cpu").predict_logits(skel, sens)
        err = float(np.abs(logits - cpu).max())
        if launches != (0, 0) or not err <= MODEL_TOL or not np.isfinite(logits).all() \
                or np.ptp(cpu, axis=0).min() <= 1e-3:
            raise AssertionError(f"{name}: card logits off the CPU's by {err} "
                                 f"(launches {launches})")
        x_d = torch.from_numpy(skel).to(dev)
        s_d = None if sens is None else torch.from_numpy(sens).to(dev)
        with torch.inference_mode():
            dev_ms = cuda_ms(lambda: pred.forward(x_d, s_d), iters=10)
            busy, activities = device_activity(lambda: pred.forward(x_d, s_d), 3)
        busy_ms = None if busy is None else busy / 3
        for _ in range(2):
            pred.predict_logits(skel, sens)
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.predict_logits(skel, sens)
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        lat = measure_push_latency(StreamingClassifier(pred, seq_len=d.seq_len), n_pushes=30,
                                   warmup=5, sensor_dim=d.sensor_dim if pred.requires_sensor
                                   else None)
        busy_txt = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms"
        log(f"8b: {name} ({preset}, full width) batch {BATCH}: card vs CPU max_abs_err="
            f"{err:.3e} (|logits| max {np.abs(cpu).max():.3f}); {dev_ms:.3f} ms/forward "
            f"(events), device busy {busy_txt} in {activities / 3:.0f} device activities a "
            f"forward; host {host_ms:.3f} ms/call -> {BATCH / host_ms * 1e3:.0f} windows/s; "
            f"push p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms")
        rows.append({"family": name, "preset": preset, "batch": BATCH, "max_abs_err": err,
                     "device_ms_per_forward": dev_ms, "device_busy_ms_per_forward": busy_ms,
                     "device_activities_per_forward": activities / 3,
                     "host_ms_per_call": host_ms,
                     "windows_per_s": BATCH / host_ms * 1e3, "push_p50_ms": lat["p50_ms"],
                     "push_p99_ms": lat["p99_ms"]})
    return rows


def k_copies_through_the_kernels(dev, rng, cfg, sd, cfg_s, sd_s):
    """Phase 8c: ``num_copies=2`` on the flagship (14 K1 launches a T=15
    slice) and on ``stgcan`` (one K2 launch a slice), counted over one
    batch-128 forward and held against the CPU Predictor's k-copies; then
    every kernel at the slices' shapes against its plain version at
    KERNEL_TOL. Returns the rows and the kernels' largest errors."""
    rows, k1_err, k2_err = [], 0.0, 0.0
    for label, c, state, want in (("gstcan_urfall_3stream", cfg, sd, (28, 0)),
                                  ("default_urfall", cfg_s, sd_s, (0, 2))):
        d = c.data
        skel = rng.normal(size=(BATCH, d.seq_len, d.num_joints, d.in_channels)).astype(
            np.float32)
        sens = rng.normal(size=(BATCH, d.seq_len, d.sensor_dim)).astype(np.float32)
        pred = Predictor(c, state, batch_size=BATCH, device=dev, num_copies=2)
        sens = sens if pred.requires_sensor else None
        fused_stgcan_block.launches = fused_backbone_forward.launches = 0
        logits = pred.predict_logits(skel, sens)
        launches = (fused_stgcan_block.launches, fused_backbone_forward.launches)
        cpu = Predictor(c, state, batch_size=BATCH, device="cpu",
                        num_copies=2).predict_logits(skel, sens)
        err = float(np.abs(logits - cpu).max())
        log(f"8c: {label} num_copies=2 batch {BATCH}: stgcan_block {launches[0]}, "
            f"fused_backbone {launches[1]} launches; logits vs CPU max_abs_err={err:.3e}")
        if launches != want or not err <= MODEL_TOL:
            raise AssertionError(f"{label} k-copies: launches {launches}, off by {err}")
        x = torch.from_numpy(skel[:, :15].copy()).to(dev)
        if pred.folded is not None:
            for n in (BATCH, 1):
                out = fused_backbone_forward(x[:n].contiguous(), pred.folded)
                kerr = (out - fused_backbone_reference(x[:n], pred.folded)).abs().max().item()
                log(f"check fused_backbone T=15 N={n}: max_abs_err={kerr:.3e}")
                if not kerr <= KERNEL_TOL:
                    raise AssertionError(f"fused_backbone at T=15 off by {kerr}")
                k2_err = max(k2_err, kerr)
        else:
            for fb, t in ((pred.pts_fb, 15), (pred.mot_fb, 14)):
                for folded, stride, mode in fb.blocks:
                    cin = folded.gcn_w.shape[0]
                    xb = torch.from_numpy(rng.normal(size=(BATCH, t, 14, cin)).astype(
                        np.float32)).to(dev)
                    out = fused_stgcan_block(xb, folded, stride, mode)
                    kerr = (out - stgcan_block_reference(xb, folded, stride, mode)
                            ).abs().max().item()
                    log(f"check stgcan_block Cin={cin} T={t} stride={stride} {mode:8s} "
                        f"N={BATCH}: max_abs_err={kerr:.3e}")
                    if not kerr <= KERNEL_TOL:
                        raise AssertionError(f"stgcan_block at T={t} off by {kerr}")
                    k1_err = max(k1_err, kerr)
                    t = (t - 1) // stride + 1
        rows.append({"model": label, "num_copies": 2, "launches": list(launches),
                     "max_abs_err": err})
    return rows, k1_err, k2_err


def train_families(dev, card):
    """Phase 8d: ``run_fold`` of ``musa_harup`` (2 epochs) and
    ``targcn_harup`` (1 epoch) on 2,048 synthetic windows, their best
    checkpoints served through ``Predictor`` (no kernel) against the
    trainer's eval forward; train windows/s at the preset's batch for
    ``musa``, ``targcn`` and ``skeleton_transformer``."""
    served = [train_then_serve("musa_harup", 2, dev, k1_per_forward=0, k2_per_forward=0),
              train_then_serve("targcn_harup", 1, dev, k1_per_forward=0, k2_per_forward=0)]
    data = to_device(make_synthetic(n_windows=4096, num_classes=11, sensor_dim=15, seed=SEED),
                     dev)
    rows = []
    for preset, steps in (("musa_harup", 10), ("targcn_harup", 20),
                          ("skeleton_transformer_harup", 20)):
        cfg = load_config(preset_path(preset))
        rows.append(train_timing(cfg, data, cfg.train.batch_size, "float32", dev, card, steps))
    return served, rows


# ---- phase 9: k-fold CV, grid search, CSV loading, the serving CLI, export ----

CV_WINDOWS = 1024


def cv_run(preset, folds, epochs, out, dev, k1_per_forward, k2_per_forward):
    """Phases 9a, 9b: ``cli.main --cv`` on CV_WINDOWS synthetic windows at the
    preset's full width and batch; the CLI's files checked; each fold's
    ``best`` served by ``Predictor.from_checkpoint`` with its launches counted
    over one batch-128 forward (counts set to 0 just before, read just after)
    and held at MODEL_TOL against the trainer's own eval forward of that
    state (``Checkpointer.restore`` into a train state, plain modules, full
    float32). Returns the row of timings and errors."""
    cfg = load_config(preset_path(preset))
    d = cfg.data
    t0 = time.perf_counter()
    res = train_cli.main(["--config", preset, "--cv", "--folds", str(folds), "--epochs",
                          str(epochs), "--synthetic-windows", str(CV_WINDOWS),
                          "--output-dir", out])
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    with open(os.path.join(out, "cv_results.json")) as fh:
        if json.load(fh)["summary"] != res["summary"] or len(res["folds"]) != folds:
            raise AssertionError(f"{preset}: cv_results.json disagrees with the run")
    data = load_dataset(d.dataset, seq_len=d.seq_len, num_joints=d.num_joints,
                        num_classes=d.num_classes, sensor_dim=d.sensor_dim, seed=cfg.seed,
                        n_windows=CV_WINDOWS)
    b = cfg.train.batch_size
    n_train = [len(f["train"]) // b * b if cfg.train.drop_last else len(f["train"])
               for f in kfold_datasets(data, n_folds=folds, seed=cfg.seed,
                                       by_video=d.split_by_video, stratify=d.stratify_folds)]
    skel, sens = data.features[:BATCH], data.sensors[:BATCH]
    epoch_s, errs, launches = [], [], []
    for i in range(folds):
        with open(os.path.join(out, f"fold{i}", "history.csv")) as fh:
            hist = list(csv.DictReader(fh))
        for name in ("best", "latest"):
            if not os.path.exists(os.path.join(out, "ckpt", f"fold{i}", name, "checkpoint.pt")):
                raise AssertionError(f"{preset}: fold {i} wrote no {name} checkpoint")
        if len(hist) != epochs or not all(np.isfinite(float(r["train_loss"])) for r in hist):
            raise AssertionError(f"{preset}: fold {i} history.csv {hist}")
        epoch_s.append(sum(float(r["epoch_time"]) for r in hist))
        fold_dir = os.path.join(out, "ckpt", f"fold{i}")
        pred = Predictor.from_checkpoint(cfg, fold_dir, which="best", batch_size=BATCH,
                                         device=dev)
        fused_stgcan_block.launches = fused_backbone_forward.launches = 0
        logits = pred.predict_logits(skel, sens if pred.requires_sensor else None)
        launches.append([fused_stgcan_block.launches, fused_backbone_forward.launches])
        state = create_train_state(cfg, build_optimizer(cfg), seed=SEED, device=dev)
        state, _, _ = Checkpointer(fold_dir).restore("best", state)
        with torch.no_grad(), full_float32():
            ref = state.model.eval()(torch.from_numpy(skel).to(dev),
                                     torch.from_numpy(sens).to(dev)).cpu().numpy()
        errs.append(float(np.abs(logits - ref).max()))
        if launches[-1] != [k1_per_forward, k2_per_forward] or not errs[-1] <= MODEL_TOL \
                or not np.isfinite(logits).all():
            raise AssertionError(f"{preset}: fold {i} best served through {launches[-1]} "
                                 f"launches, off the trainer's forward by {errs[-1]}")
    windows_per_s = sum(n * epochs for n in n_train) / sum(epoch_s)
    log(f"9: {preset} --cv --folds {folds} --epochs {epochs}, {CV_WINDOWS} windows, batch "
        f"{cfg.train.batch_size}: {cv_s:.2f} s ({cv_s / folds:.2f} s a fold), "
        f"{windows_per_s:.1f} train windows/s of epoch time; test acc "
        f"{[round(r['test_accuracy'], 4) for r in res['folds']]}; each fold's best served "
        f"through {launches} (stgcan_block, fused_backbone) launches, vs the trainer's eval "
        f"forward max_abs_err {errs}")
    return {"preset": preset, "folds": folds, "epochs": epochs, "windows": CV_WINDOWS,
            "batch": cfg.train.batch_size, "cv_s": cv_s, "s_per_fold": cv_s / folds,
            "epoch_s": epoch_s, "train_windows_per_s": windows_per_s,
            "summary": res["summary"], "launches": launches, "max_abs_err": errs}


def csv_tree_check(root):
    """Phase 9d: a Gen-3 CSV tree (100 videos x 300 frames, 13 joints, one
    NaN cell in every tenth video, rows shuffled within each file) written
    here and read by ``load_csv_windows`` through the native slicer, which
    must be built; held exactly against the numpy slicer on the same table,
    sorted as the loader sorts it."""
    from fall_multimodal_tpu_torch.data import native
    from fall_multimodal_tpu_torch.data.preprocess import add_center_joint, scale_pose

    rng = np.random.default_rng(SEED)
    cols = [f"j{j}_{a}" for j in range(13) for a in ("x", "y", "s")]
    classes = ["fall", "lie", "sit", "walk"]
    tables, labels, codes = [], [], []
    for v in range(100):
        vals = np.float32(np.round(rng.random((300, len(cols))), 6))
        if v % 10 == 3:
            vals[150, 5] = np.nan
        lab = rng.integers(0, 4, 300 // 30).repeat(30)
        path = os.path.join(root, f"subject{v % 17}", f"video{v:03d}.csv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(",".join(["video", "frame"] + cols + ["label"]) + "\n")
            for f in rng.permutation(300):
                fh.write(",".join([f"video{v:03d}", str(f)] + [repr(float(x)) for x in vals[f]]
                                  + [classes[lab[f]]]) + "\n")
        tables.append(vals)
        labels.append(np.eye(4, dtype=np.float32)[lab])
        codes.append(np.full(300, v, np.int64))
    table, labs, codes = np.concatenate(tables), np.concatenate(labels), np.concatenate(codes)
    t0 = time.perf_counter()
    data = load_csv_windows(root, seq_len=30)
    load_s = time.perf_counter() - t0
    built = native.native_available()
    windows, starts = native.slice_windows_numpy(table, codes, 30)
    feats = windows.reshape(-1, 30, 13, 3).copy()
    feats[..., :2] = scale_pose(feats[..., :2])
    want = add_center_joint(feats)
    same = (built and data.features.shape == want.shape
            and np.array_equal(data.features, want)
            and np.array_equal(data.labels, native.window_mean_labels(labs, starts, 30))
            and data.videos.tolist() == [f"video{c:03d}" for c in codes[starts]])
    log(f"9d: CSV tree of {len(table)} rows in 100 files -> {len(data)} windows in "
        f"{load_s:.3f} s ({len(table) / load_s:.0f} rows/s); native slicer built: {built} "
        f"({native.library_path()}); equal to the numpy slicer: {same}")
    if not same:
        raise AssertionError("the CSV loader with the native slicer disagrees with the numpy "
                             "slicer, or the native slicer was not built")
    return {"rows": len(table), "windows": len(data), "load_s": load_s, "native": built}


def serve_cli_check(out, dev):
    """Phase 9e: ``serve predict`` on the ``stgcan`` run's ``ckpt/fold0 --which
    best`` from an ``.npy``, an ``.npz`` and a prep-pipeline pickle of the same
    windows: equal predictions, equal to the Predictor's probabilities."""
    import pickle

    cfg = load_config(preset_path("default_urfall"))
    d = cfg.data
    data = make_synthetic(n_windows=300, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          seed=SEED + 1)
    np.save(os.path.join(out, "x.npy"), data.features)
    np.savez(os.path.join(out, "x.npz"), skeleton=data.features)
    with open(os.path.join(out, "x.pkl"), "wb") as fh:
        pickle.dump((data.videos, data.features, data.labels), fh)
    fold = os.path.join(out, "ckpt", "fold0")
    tables = []
    for name in ("x.npy", "x.npz", "x.pkl"):
        csv_out = os.path.join(out, f"{name}.csv")
        serve_cli.main(["predict", "--config", "default_urfall", "--checkpoint", fold,
                        "--which", "best", "--input", os.path.join(out, name), "--output",
                        csv_out, "--proba"])
        with open(csv_out) as fh:
            tables.append(np.asarray([[float(x) for x in row[1:]]
                                      for row in list(csv.reader(fh))[1:]]))
    want = Predictor.from_checkpoint(cfg, fold, device=dev).predict_proba(data.features)
    err = float(np.abs(tables[0][:, 1:] - want).max())
    same = all(np.array_equal(tables[0], t) for t in tables[1:])
    log(f"9e: serve predict --checkpoint ckpt/fold0 --which best from .npy/.npz/pickle: "
        f"{len(tables[0])} windows, predictions equal: {same}; probabilities vs the "
        f"Predictor max_abs_err={err:.3e}")
    if not same or not err <= 1e-6 or not np.array_equal(tables[0][:, 0], want.argmax(-1)):
        raise AssertionError(f"serve predict disagrees across input formats ({same}, {err})")
    return {"windows": len(tables[0]), "inputs": ["npy", "npz", "pickle"], "max_abs_err": err}


def export_check(out, dev, defaults):
    """Phase 9f: the flagship's fold-0 ``best`` exported by ``serve export`` at
    batch 128 on the card; the loaded callable under PyTorch's default TF32
    flags against the Predictor's logits at MODEL_TOL; serving windows/s of
    the fold checkpoint through the Predictor (host clock, 1,024 windows a
    call)."""
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    d = cfg.data
    fold = os.path.join(out, "ckpt", "fold0")
    path = os.path.join(out, "model.pt2")
    t0 = time.perf_counter()
    serve_cli.main(["export", "--config", "gstcan_urfall_3stream", "--checkpoint", fold,
                    "--output", path, "--batch-size", str(BATCH)])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, "rb") as fh:
        forward = load_pt2(fh.read())
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 2)
    skel = rng.normal(size=(1024, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(1024, d.seq_len, d.sensor_dim)).astype(np.float32)
    pred = Predictor.from_checkpoint(cfg, fold, batch_size=BATCH, device=dev)
    want = pred.predict_logits(skel[:BATCH], sens[:BATCH])
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    try:
        got = forward(torch.from_numpy(skel[:BATCH]).to(dev),
                      torch.from_numpy(sens[:BATCH]).to(dev)).cpu().numpy()
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    err = float(np.abs(got - want).max())
    with torch.no_grad(), full_float32():
        plain = pred.model(torch.from_numpy(skel[:BATCH]).to(dev),
                           torch.from_numpy(sens[:BATCH]).to(dev)).cpu().numpy()
    err_plain = float(np.abs(got - plain).max())
    pred.predict_logits(skel, sens)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_logits(skel, sens)
    serve_wps = reps * len(skel) / (time.perf_counter() - t0)
    log(f"9f: export of the flagship's fold-0 best at batch {BATCH} in {export_s:.2f} s "
        f"({os.path.getsize(path)} bytes), load {load_s:.2f} s; exported logits under the "
        f"default flags {defaults} (after: {after}) vs the Predictor max_abs_err={err:.3e}, "
        f"vs the plain eval forward in full float32 {err_plain:.3e} (|logits| max "
        f"{np.abs(want).max():.3f}); serving from the fold checkpoint {serve_wps:.0f} "
        f"windows/s")
    if not err <= MODEL_TOL or after != defaults:
        raise AssertionError(f"exported forward off the Predictor by {err}")
    return {"export_s": export_s, "load_s": load_s, "bytes": os.path.getsize(path),
            "max_abs_err": err, "max_abs_err_vs_plain": err_plain,
            "logits_abs_max": float(np.abs(want).max()), "serve_windows_per_s": serve_wps}


def cv_phase(dev, defaults, card):
    """Phase 9: the CV protocol's path on the card through the CLIs."""
    root = os.path.join(ROOT, "outputs", "chip_smoke", "cv")
    shutil.rmtree(root, ignore_errors=True)
    t9 = time.perf_counter()
    flagship = cv_run("gstcan_urfall_3stream", 3, 2, os.path.join(root, "gstcan"), dev,
                      k1_per_forward=14, k2_per_forward=0)
    stgcan_out = os.path.join(root, "stgcan")
    stgcan = cv_run("default_urfall", 2, 1, stgcan_out, dev, k1_per_forward=0,
                    k2_per_forward=1)
    grid_out = os.path.join(root, "grid")
    t0 = time.perf_counter()
    train_cli.main(["--config", "musa_harup", "--grid", '{"embed_dim": [32, 64]}',
                    "--epochs", "1", "--synthetic-windows", str(CV_WINDOWS),
                    "--output-dir", grid_out])
    grid_s = time.perf_counter() - t0
    with open(os.path.join(grid_out, "grid_results.csv")) as fh:
        grid = list(csv.DictReader(fh))
    log(f"9c: musa_harup --grid embed_dim [32, 64], 1 epoch, {CV_WINDOWS} windows in "
        f"{grid_s:.2f} s: {grid}")
    if [r["embed_dim"] for r in grid] != ["32", "64"] or sorted(r["rank"] for r in grid) \
            != ["1", "2"]:
        raise AssertionError(f"grid_results.csv: {grid}")
    csv_tree = csv_tree_check(os.path.join(root, "csv_tree"))
    served = serve_cli_check(stgcan_out, dev)
    export = export_check(os.path.join(root, "gstcan"), dev, defaults)
    phase_s = time.perf_counter() - t9
    log(f"phase 9: {phase_s:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return {"cv": [flagship, stgcan], "grid": {"rows": grid, "s": grid_s},
            "csv_tree": csv_tree, "serve_cli": served, "export": export,
            "phase_s": phase_s, "card": card}


# ---- phase 10: fold-parallel CV, data parallelism ---------------------------

CV_PARALLEL_FOLDS = 5


def fold_states(cfg, folds, dev, steps_per_epoch):
    """``folds`` seeded train states of ``cfg`` on ``dev`` (fold k seeded
    ``cfg.seed + k``, as ``cross_validate_vmapped`` seeds them), stacked."""
    optimizer = build_optimizer(cfg.optim, scheduler=cfg.lr_scheduler,
                                steps_per_epoch=steps_per_epoch, max_norm=cfg.train.max_norm)
    states = [create_train_state(cfg, optimizer, seed=cfg.seed + k, device=dev)
              for k in range(folds)]
    return stack_states(states, optimizer, torch.Generator(dev).manual_seed(cfg.seed)), \
        optimizer


def vmapped_step_checks(cfg, data_np, dev, defaults):
    """Phase 10a's step checks at full width, batch 32: (1) one vmapped step of
    two folds from one stacked state on the card, under PyTorch's default
    TF32 flags, against the same step on the CPU: per-fold loss within
    TRAIN_LOSS_RTOL; (2) four vmapped steps of CV_PARALLEL_FOLDS folds on the
    card against the port's single-fold step of each fold on the same rows,
    taken before each step from the fold's stacked state (``load_fold``):
    per-step loss within FOLD_STEP_TOL. Single folds running free from the
    same init are printed beside them: RMSprop's first update is +-10 lr
    whatever a gradient's size, so float noise in small gradients parts free
    runs after a step. Returns the errors."""
    k, b = CV_PARALLEL_FOLDS, cfg.train.batch_size
    rows = np.random.default_rng(SEED).integers(0, len(data_np), (4, k, b))
    step = make_fold_train_step(softmax_before_ce=cfg.model.softmax_output)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    losses = []
    for on in (dev, torch.device("cpu")):     # two folds: the CPU's step is the slow one
        fs, _ = fold_states(cfg, 2, on, 4)
        data = to_device(data_np, on)
        _, m = step(fs, data, torch.as_tensor(rows[0, :2], device=on))
        losses.append(m["loss"].cpu().numpy())
    card_vs_cpu = np.abs(losses[0] - losses[1]) / np.abs(losses[1])
    after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    log(f"10a: vmapped step of 2 full-width flagship folds, batch {b}, under the default "
        f"flags {defaults}: loss card {losses[0].tolist()} cpu {losses[1].tolist()} "
        f"(rel err {card_vs_cpu.tolist()}); flags after {after}")
    if not (card_vs_cpu.max() <= TRAIN_LOSS_RTOL and np.isfinite(losses[0]).all()) \
            or after != defaults:
        raise AssertionError(f"vmapped card step disagrees with the CPU ({card_vs_cpu}) or "
                             f"the caller's flags changed ({after})")
    data = to_device(data_np, dev)
    folds, optimizer = fold_states(cfg, k, dev, 4)
    singles = [create_train_state(cfg, optimizer, seed=cfg.seed + i, device=dev)
               for i in range(k)]
    free = [create_train_state(cfg, optimizer, seed=cfg.seed + i, device=dev)
            for i in range(k)]
    single_step = make_train_step(softmax_before_ce=cfg.model.softmax_output)
    vm, seq, run_free = [], [], []
    for r in rows:
        idx = torch.as_tensor(r, device=dev)
        for i, s in enumerate(singles):
            load_fold(folds, i, s)
        seq.append([float(single_step(s, gather_batch(data, idx[i]))[1]["loss"])
                    for i, s in enumerate(singles)])
        run_free.append([float(single_step(s, gather_batch(data, idx[i]))[1]["loss"])
                         for i, s in enumerate(free)])
        vm.append(step(folds, data, idx)[1]["loss"].cpu().numpy())
    vm, seq, run_free = np.array(vm), np.array(seq), np.array(run_free)
    fold_err = np.abs(vm - seq) / np.abs(seq)
    free_err = np.abs(vm - run_free) / np.abs(run_free)
    log(f"10a: vmapped folds vs the single-fold step from fold k's state, 4 steps x {k} "
        f"folds: losses vmapped {vm.round(6).tolist()}, single {seq.round(6).tolist()}; max "
        f"rel err per step {fold_err.max(1).tolist()}; single folds run free from the same "
        f"init: max rel err per step {free_err.max(1).tolist()}")
    if not fold_err.max() <= FOLD_STEP_TOL:
        raise AssertionError(f"vmapped folds part from the single-fold step: {fold_err}")
    return {"card_vs_cpu_loss_rel_err": card_vs_cpu.tolist(),
            "fold_vs_single_loss_rel_err": fold_err.max(1).tolist(),
            "fold_vs_free_single_loss_rel_err": free_err.max(1).tolist()}


def fold_step_timing(cfg, data_np, dev, folds, steps=12):
    """Host ms, CUDA-event ms and profiler device-busy ms of one vmapped step of
    ``folds`` folds and of one sequential step, batch 32, full width; peak
    memory of the vmapped steps."""
    b = cfg.train.batch_size
    data = to_device(data_np, dev)
    fs, _ = fold_states(cfg, folds, dev, steps)
    step = make_fold_train_step(softmax_before_ce=cfg.model.softmax_output)
    rng = np.random.default_rng(SEED)
    idx = torch.as_tensor(rng.integers(0, len(data_np), (steps, folds, b)), device=dev)
    for i in range(3):
        step(fs, data, idx[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(steps):
        step(fs, data, idx[i])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    busy, acts = device_activity(lambda: step(fs, data, idx[0]), 3)
    single = create_train_state(cfg, build_optimizer(cfg), seed=SEED, device=dev)
    seq = make_train_epoch(softmax_before_ce=cfg.model.softmax_output)
    flat = idx[:, 0]
    seq(single, data, flat[:3])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq(single, data, flat)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3 / steps
    seq_busy, seq_acts = device_activity(lambda: seq(single, data, flat[:1]), 3)
    row = {"folds": folds, "batch": b, "vmapped_host_ms": host_ms,
           "vmapped_device_busy_ms": None if busy is None else busy / 3,
           "vmapped_device_activities": acts / 3,
           "vmapped_device_share": None if busy is None else busy / 3 / host_ms,
           "vmapped_peak_mib": peak,
           "vmapped_step_windows_per_s": folds * b / host_ms * 1e3,
           "single_host_ms": seq_ms,
           "single_device_busy_ms": None if seq_busy is None else seq_busy / 3,
           "single_device_activities": seq_acts / 3,
           "single_step_windows_per_s": b / seq_ms * 1e3}
    row["step_speedup"] = row["vmapped_step_windows_per_s"] / row["single_step_windows_per_s"]
    busy_txt = "not measured" if busy is None else f"{busy / 3:.3f} ms"
    log(f"10a: vmapped step of {folds} folds: host {host_ms:.3f} ms, device busy {busy_txt} "
        f"({acts / 3:.0f} device activities), peak {peak:.1f} MiB -> "
        f"{row['vmapped_step_windows_per_s']:.1f} windows/s; single-fold step host "
        f"{seq_ms:.3f} ms ({seq_acts / 3:.0f} device activities) -> "
        f"{row['single_step_windows_per_s']:.1f} windows/s; {row['step_speedup']:.2f}x")
    return row


def cli_cv(preset, flag_args, folds, epochs, out, windows=CV_WINDOWS):
    """``cli.main`` with ``flag_args`` on ``windows`` synthetic windows at the
    preset's batch; seconds, windows trained, windows/s of the run."""
    t0 = time.perf_counter()
    res = train_cli.main(["--config", preset, *flag_args, "--folds", str(folds), "--epochs",
                          str(epochs), "--synthetic-windows", str(windows),
                          "--output-dir", out])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    with open(os.path.join(out, "cv_results.json")) as fh:
        if json.load(fh) != json.loads(json.dumps(res)) or len(res["folds"]) != folds:
            raise AssertionError(f"{preset} {flag_args}: cv_results.json disagrees with the run")
    cfg = load_config(preset_path(preset))
    d, b = cfg.data, cfg.train.batch_size
    data = load_dataset(d.dataset, seq_len=d.seq_len, num_joints=d.num_joints,
                        num_classes=d.num_classes, sensor_dim=d.sensor_dim, seed=cfg.seed,
                        n_windows=windows)
    fold_sets = fold_indices(cfg, data, folds)
    if "--cv-vmapped" in flag_args:      # every fold steps min(train) // batch times
        n_train = [min(len(f["train"]) for f in fold_sets) // b * b] * folds
    else:
        n_train = [len(f["train"]) // b * b for f in fold_sets]
    windows_trained = sum(n_train) * epochs
    accs = [r["test_accuracy"] for r in res["folds"]]
    if not all(np.isfinite(accs)):
        raise AssertionError(f"{preset} {flag_args}: non-finite fold results {res['folds']}")
    row = {"preset": preset, "flags": flag_args, "folds": folds, "epochs": epochs,
           "windows": windows, "batch": b, "run_s": run_s, "s_per_fold": run_s / folds,
           "train_windows": windows_trained, "train_windows_per_s_of_run": windows_trained / run_s,
           "test_accuracy": accs, "summary": res["summary"], "folds_rows": res["folds"]}
    if "--cv" in flag_args:
        epoch_s = 0.0
        for i in range(folds):
            with open(os.path.join(out, f"fold{i}", "history.csv")) as fh:
                epoch_s += sum(float(r["epoch_time"]) for r in csv.DictReader(fh))
    else:       # the vmapped driver's closing log line: "... in <s> s of epochs; ..."
        with open(os.path.join(out, "log.txt")) as fh:
            epoch_s = float(re.findall(r"in ([0-9.]+) s of epochs", fh.read())[-1])
    row["epoch_s"] = epoch_s
    row["train_windows_per_s_of_epoch_time"] = windows_trained / epoch_s
    log(f"10: {preset} {' '.join(flag_args)} --folds {folds} --epochs {epochs}, {windows} "
        f"windows, batch {b}: {run_s:.2f} s ({run_s / folds:.2f} s a fold), "
        f"{windows_trained / run_s:.1f} train windows/s of the run, "
        f"{row['train_windows_per_s_of_epoch_time']:.1f} of epoch time ({epoch_s:.2f} s); "
        f"test acc {[round(a, 4) for a in accs]}")
    return row


def run_fold_on_a_mesh(dev):
    """Phase 10d: ``run_fold`` of the flagship through a world-size-1 NCCL data
    mesh against the plain ``run_fold`` (deterministic cuDNN for both):
    curves within MESH_CURVE_TOL; one all-reduce through the group."""
    import torch.distributed as dist

    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2))
    d = cfg.data
    data = make_synthetic(n_windows=CV_WINDOWS, num_classes=d.num_classes,
                          sensor_dim=d.sensor_dim, seed=SEED)
    splits = {k: to_device(v, dev) for k, v in split_dataset(data, seed=cfg.seed).items()}
    mesh = make_mesh(1, device=dev)
    probe = torch.arange(4.0, device=dev)
    dist.all_reduce(probe, group=mesh.group)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        plain = run_fold(cfg, splits, device=dev)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        meshed = run_fold(cfg, splits, device=dev, mesh=mesh)
        mesh_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    err = max(float(np.abs(np.subtract(plain.history[k], meshed.history[k])).max())
              for k in keys)
    log(f"10d: flagship run_fold, 2 epochs, through a world-size-1 {dist.get_backend()} mesh "
        f"({mesh_s:.2f} s) vs plain ({plain_s:.2f} s): curves max abs diff {err:.3e}; "
        f"all-reduce probe {probe.tolist()}")
    if not err <= MESH_CURVE_TOL or probe.tolist() != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"run_fold on a mesh parts from the plain run: {err}")
    return {"backend": dist.get_backend(), "curves_max_abs_diff": err, "plain_s": plain_s,
            "mesh_s": mesh_s, "history": {k: meshed.history[k] for k in keys}}


def cv_parallel_phase(dev, defaults, card):
    """Phase 10: fold-parallel CV and data parallelism on the card."""
    root = os.path.join(ROOT, "outputs", "chip_smoke", "cv_parallel")
    shutil.rmtree(root, ignore_errors=True)
    t10 = time.perf_counter()
    preset = "gstcan_urfall_3stream"
    cfg = load_config(preset_path(preset))
    d = cfg.data
    data_np = make_synthetic(n_windows=CV_WINDOWS, num_classes=d.num_classes,
                             sensor_dim=d.sensor_dim, seed=SEED)
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    checks = vmapped_step_checks(cfg, data_np, dev, defaults)
    timing = fold_step_timing(cfg, data_np, dev, CV_PARALLEL_FOLDS)
    k, e = CV_PARALLEL_FOLDS, 2
    vmapped = cli_cv(preset, ["--cv-vmapped"], k, e, os.path.join(root, "vmapped"))
    sequential = cli_cv(preset, ["--cv"], k, e, os.path.join(root, "sequential"))
    sharded = cli_cv(preset, ["--cv-vmapped", "--cv-mesh", "1"], k, e,
                     os.path.join(root, "mesh1"))
    mesh_err = max(abs(a[m] - b[m]) for a, b in zip(vmapped["folds_rows"], sharded["folds_rows"])
                   for m in a)
    log(f"10b: --cv-vmapped --cv-mesh 1 vs unsharded: per-fold results max abs diff "
        f"{mesh_err:.3e}")
    if not mesh_err <= CV_MESH_TOL:
        raise AssertionError(f"--cv-mesh 1 disagrees with the unsharded run: {mesh_err}")
    lstm = cli_cv("sensor_cnn_bilstm_urfall", ["--cv-vmapped"], 10, e,
                  os.path.join(root, "cnn_bilstm"))
    on_mesh = run_fold_on_a_mesh(dev)
    launches = [fused_stgcan_block.launches, fused_backbone_forward.launches]
    phase_s = time.perf_counter() - t10
    speedup = vmapped["train_windows_per_s_of_run"] / sequential["train_windows_per_s_of_run"]
    epoch_speedup = (vmapped["train_windows_per_s_of_epoch_time"]
                     / sequential["train_windows_per_s_of_epoch_time"])
    log(f"10: vmapped / sequential train windows/s of the run: {speedup:.2f}x, of epoch "
        f"time: {epoch_speedup:.2f}x; kernel "
        f"launches on this path (stgcan_block, fused_backbone): {launches}; phase 10: "
        f"{phase_s:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    for row in (vmapped, sequential, sharded, lstm):
        row.pop("folds_rows")
    return {"cv_parallel": {"step_checks": checks, "step_timing": timing,
                            "vmapped": vmapped, "sequential": sequential,
                            "cv_mesh_1": dict(sharded, max_abs_diff=mesh_err),
                            "cnn_bilstm_vmapped": lstm, "run_fold_mesh_1": on_mesh,
                            "run_speedup": speedup, "epoch_time_speedup": epoch_speedup,
                            "kernel_launches": launches,
                            "phase_s": phase_s, "card": card}}


# ---- phase 11: fused epochs, the blocks no preset builds ----------------------

FUSED_TOL = 1e-6         # fused vs per-epoch runs: the same operations, deterministic cuDNN
FUSED_EPOCHS = 4


def fit_from(cfg, splits, state0, dev, epochs, scan_epochs):
    """``fit`` of ``cfg`` from a copy of ``state0`` with the scan impl:
    (result, seconds, train windows/s of the run)."""
    state = state0.snapshot()
    b = cfg.train.batch_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fit(state, splits, epochs=epochs, batch_size=b,
                 num_classes=splits["train"].labels.shape[-1],
                 label_smoothing=cfg.train.label_smoothing,
                 softmax_before_ce=cfg.model.softmax_output, drop_last=cfg.train.drop_last,
                 shuffle_seed=cfg.seed, epoch_impl="scan", scan_epochs=scan_epochs,
                 augment_fn=make_augment_fn(cfg.augment, cfg.graph.layout))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return result, run_s, splits["train"].n // b * b * epochs / run_s


def state_diff(a, b):
    """Max abs difference over every tensor of two train states (weights,
    buffers, optimizer state and accumulators), and whether their host fields
    (step counters, learning rates, generator state) are equal."""
    errs = [float((x.double() - y.double()).abs().max()) for x, y
            in zip(a.model.state_dict().values(), b.model.state_dict().values())]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    same = (oa["inner"]["state"].keys() == ob["inner"]["state"].keys()
            and oa["inner"]["param_groups"] == ob["inner"]["param_groups"]
            and (oa["mini_step"], oa["gradient_step"]) == (ob["mini_step"], ob["gradient_step"])
            and a.step == b.step
            and torch.equal(a.generator.get_state(), b.generator.get_state()))
    for i, entries in oa["inner"]["state"].items():
        for key, v in entries.items():
            w = ob["inner"]["state"].get(i, {}).get(key)
            same = same and w is not None
            if torch.is_tensor(v) and w is not None:
                errs.append(float((v.double() - w.double().to(v.device)).abs().max()))
    for x, y in zip(oa["acc"] or [], ob["acc"] or []):
        errs.append(float((x - y).abs().max()))
    return max(errs), same


def curves_diff(a, b):
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    if any(len(a.history[k]) != len(b.history[k]) for k in keys):
        return float("inf")
    return max(float(np.abs(np.subtract(a.history[k], b.history[k])).max(initial=0.0))
               for k in keys)


def fused_three_ways(preset, dev, card, epochs, windows=CV_WINDOWS):
    """Phase 11a/11c: ``fit`` of ``preset`` at full width from one seeded state,
    per epoch, ``scan_epochs=True`` and ``scan_epochs=2``: curves, best
    accuracy and every field of the best and final states within FUSED_TOL;
    windows/s of each run."""
    cfg = load_config(preset_path(preset))
    d = cfg.data
    data = make_synthetic(n_windows=windows, num_classes=d.num_classes,
                          sensor_dim=d.sensor_dim, seed=SEED)
    splits = {k: to_device(v, dev) for k, v in split_dataset(data, seed=cfg.seed).items()}
    steps = max(1, splits["train"].n // cfg.train.batch_size)
    state0 = create_train_state(cfg, build_optimizer(cfg, steps_per_epoch=steps), seed=SEED,
                                device=dev)
    fit_from(cfg, splits, state0, dev, 1, True)          # warm-up: cuDNN's first calls
    runs = {name: fit_from(cfg, splits, state0, dev, epochs, se)
            for name, se in (("per_epoch", False), ("fused", True), ("fused_chunks_of_2", 2))}
    base = runs["per_epoch"][0]
    row = {"preset": preset, "epochs": epochs, "batch": cfg.train.batch_size,
           "train_windows": splits["train"].n, "val_acc": base.history["val_acc"],
           "train_loss": base.history["train_loss"], "card": card}
    ok = True
    for name, (result, run_s, rate) in runs.items():
        row[f"{name}_s"] = run_s
        row[f"{name}_windows_per_s"] = rate
        if name == "per_epoch":
            continue
        best_err, best_same = state_diff(base.best_state, result.best_state)
        final_err, final_same = state_diff(base.state, result.state)
        err = max(curves_diff(base, result), best_err, final_err,
                  abs(base.best_val_accuracy - result.best_val_accuracy),
                  abs(base.test.accuracy - result.test.accuracy))
        row[f"{name}_max_abs_diff"] = err
        row[f"{name}_host_fields_equal"] = best_same and final_same
        ok = ok and err <= FUSED_TOL and best_same and final_same
    log(f"11: {preset} fit, {epochs} epochs, batch {cfg.train.batch_size}, "
        f"{splits['train'].n} train windows: per epoch {row['per_epoch_s']:.2f} s "
        f"({row['per_epoch_windows_per_s']:.1f} windows/s), fused {row['fused_s']:.2f} s "
        f"({row['fused_windows_per_s']:.1f}), chunks of 2 {row['fused_chunks_of_2_s']:.2f} s "
        f"({row['fused_chunks_of_2_windows_per_s']:.1f}); fused vs per epoch max abs diff "
        f"{row['fused_max_abs_diff']:.3e} / {row['fused_chunks_of_2_max_abs_diff']:.3e}, "
        f"host fields equal {row['fused_host_fields_equal']} / "
        f"{row['fused_chunks_of_2_host_fields_equal']}; val acc {row['val_acc']} [{card}]")
    if not ok:
        raise AssertionError(f"{preset}: fused runs part from the per-epoch run: {row}")
    return row, runs["fused"][0], cfg, data


def sync_free_chunk(preset, dev):
    """Phase 11b: one fused chunk of two epochs (the first allocates the best
    copy) of ``preset`` at full width under ``torch.cuda.set_sync_debug_mode
    ("error")``: no operation inside may wait for the card or read from it."""
    cfg = load_config(preset_path(preset))
    d = cfg.data
    data = make_synthetic(n_windows=CV_WINDOWS, num_classes=d.num_classes,
                          sensor_dim=d.sensor_dim, seed=SEED)
    splits = {k: to_device(v, dev) for k, v in split_dataset(data, seed=cfg.seed).items()}
    state = create_train_state(cfg, build_optimizer(cfg), seed=SEED, device=dev)
    fused = FusedEpochs(
        state, splits,
        make_train_epoch(cfg.train.label_smoothing, cfg.model.softmax_output, impl="scan",
                         augment_fn=make_augment_fn(cfg.augment, cfg.graph.layout)),
        make_eval_epoch(d.num_classes, cfg.train.label_smoothing, cfg.model.softmax_output),
        cfg.train.batch_size, cfg.train.drop_last, cfg.seed, -1.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        curves = fused.chunk([1, 2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = curves.cpu().numpy()
    log(f"11b: {preset} fused chunk of 2 epochs under sync debug mode 'error': no "
        f"synchronising operation; curves {host.round(4).tolist()}")
    if not np.isfinite(host).all():
        raise AssertionError(f"{preset}: the sync-free chunk went non-finite: {host}")
    return {"preset": preset, "epochs": 2, "synchronising_ops": 0}


def serve_fused_best(cfg, result, data, dev):
    """Phase 11a: the fused run's best state served through ``Predictor`` (14
    K1 launches a batch-128 forward) against the trainer's eval forward."""
    pred = Predictor(cfg, result.best_state.model.state_dict(), batch_size=BATCH, device=dev)
    skel, sens = data.features[:BATCH], data.sensors[:BATCH]
    before = (fused_stgcan_block.launches, fused_backbone_forward.launches)
    logits = pred.predict_logits(skel, sens)
    launches = (fused_stgcan_block.launches - before[0],
                fused_backbone_forward.launches - before[1])
    model = result.best_state.model.eval()
    with torch.no_grad(), full_float32():
        ref = model(torch.from_numpy(skel).to(dev), torch.from_numpy(sens).to(dev)).cpu().numpy()
    err = float(np.abs(logits - ref).max())
    log(f"11a: fused best state served: stgcan_block {launches[0]}, fused_backbone "
        f"{launches[1]} launches per batch-{BATCH} forward; vs the trainer's eval forward "
        f"max_abs_err={err:.3e}")
    if launches != (14, 0) or not err <= MODEL_TOL:
        raise AssertionError(f"fused best state served through {launches} launches, off by {err}")
    return {"launches": list(launches), "max_abs_err": err}


def fused_cv(dev, card):
    """Phase 11d: ``cross_validate_vmapped`` of the flagship, 5 folds x 2 epochs
    on CV_WINDOWS windows, fused against per epoch: per-fold curves and
    results within FUSED_TOL."""
    cfg = load_config(preset_path("gstcan_urfall_3stream"), overrides={"train.epoch_impl": "scan"})
    d = cfg.data
    data = make_synthetic(n_windows=CV_WINDOWS, num_classes=d.num_classes,
                          sensor_dim=d.sensor_dim, seed=SEED)
    out = {}
    for name, se in (("per_epoch", False), ("fused", True)):
        curves = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cross_validate_vmapped(
            cfg, data, n_folds=CV_PARALLEL_FOLDS, epochs=2, scan_epochs=se, device=dev,
            metrics_factory=lambda k, c=curves: (
                lambda e, sc: c.setdefault(k, []).append(sorted(sc.items()))))
        torch.cuda.synchronize()
        out[name] = (res, curves, time.perf_counter() - t0)
    (a, ca, sa), (b, cb, sb) = out["per_epoch"], out["fused"]
    err = max(abs(x[m] - y[m]) for x, y in zip(a["folds"], b["folds"]) for m in x)
    err = max([err] + [abs(u[1] - v[1]) for k in ca for p, q in zip(ca[k], cb[k])
                       for u, v in zip(p, q)])
    same_shape = ca.keys() == cb.keys() and all(len(ca[k]) == len(cb[k]) == 2 for k in ca)
    log(f"11d: flagship cross_validate_vmapped, {CV_PARALLEL_FOLDS} folds x 2 epochs: per "
        f"epoch {sa:.2f} s, fused {sb:.2f} s; curves and results max abs diff {err:.3e} "
        f"[{card}]")
    if not (err <= FUSED_TOL and same_shape):
        raise AssertionError(f"fused CV parts from the per-epoch CV: {err}")
    return {"folds": CV_PARALLEL_FOLDS, "epochs": 2, "per_epoch_s": sa, "fused_s": sb,
            "max_abs_diff": err, "test_accuracy": [r["test_accuracy"] for r in b["folds"]]}


def new_blocks_card_vs_cpu(dev):
    """Phase 11e: the blocks no preset builds, card against CPU at the
    ``skeleton_transformer_harup`` widths (embedding 32, 8 heads x 16) and
    ``musa_harup``'s (128 channels after the first stage), eval and train
    mode with every draw off, batch 32: MODEL_TOL."""
    from fall_multimodal_tpu_torch.models import musa, skeleton_transformer as st

    args = dict(head_dim=16, n_heads=8, n_joints=14, seq_len=30, ffn_dropout=0.0)
    torch.manual_seed(SEED)
    blocks = {
        "B2TSpatialTemporalBlock(layernorm)": (
            st.B2TSpatialTemporalBlock(32, **args, normalization="layernorm"), 32),
        "PreNormBlock": (st.PreNormBlock(32, **args), 32),
        "ParallelB2TBlock": (st.ParallelB2TBlock(32, **args), 32),
        "GrowthBlock": (st.GrowthBlock(32, 16, 8, 14, 30, growth=16), 32),
        "SepTemporalBlock(expand 2, no residual)": (
            musa.SepTemporalBlock(128, 5, stride=2, expand_ratio=2, keep_prob=1.0,
                                  residual=False), 128),
    }
    blocks["GrowthBlock"][0].block.feed_forward_network[3].p = 0.0
    gen = torch.Generator().manual_seed(SEED)
    rows = {}
    for name, (block, c) in blocks.items():
        x = torch.randn(32, 30, 14, c, generator=gen)
        errs = []
        for train in (False, True):
            cpu_block = block.train(train)
            card_block = copy.deepcopy(cpu_block).to(dev)
            with torch.no_grad(), full_float32():
                ref = cpu_block(x, torch.Generator().manual_seed(0))
                out = card_block(x.to(dev), torch.Generator(dev).manual_seed(0)).cpu()
            errs.append(float((out - ref).abs().max()))
        rows[name] = {"eval_max_abs_err": errs[0], "train_max_abs_err": errs[1],
                      "out_shape": list(ref.shape)}
    log(f"11e: new blocks, card vs CPU, batch 32: {rows}")
    if not all(max(r["eval_max_abs_err"], r["train_max_abs_err"]) <= MODEL_TOL
               for r in rows.values()):
        raise AssertionError(f"a new block parts from the CPU on the card: {rows}")
    return rows


def fused_phase(dev, card):
    """Phase 11: fused epochs (the flagship three ways and served, a
    sync-free chunk, musa, the fused CV) and the blocks no preset builds."""
    t11 = time.perf_counter()
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        sync = sync_free_chunk("gstcan_urfall_3stream", dev)
        fused_stgcan_block.launches = fused_backbone_forward.launches = 0
        flagship, best, cfg, data = fused_three_ways("gstcan_urfall_3stream", dev, card,
                                                     FUSED_EPOCHS)
        served = serve_fused_best(cfg, best, data, dev)
        launches = [fused_stgcan_block.launches, fused_backbone_forward.launches]
        musa_row, _, _, _ = fused_three_ways("musa_harup", dev, card, 2)
        cv_row = fused_cv(dev, card)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    blocks = new_blocks_card_vs_cpu(dev)
    phase_s = time.perf_counter() - t11
    log(f"phase 11: {phase_s:.1f} s; kernel launches on the fused flagship path "
        f"(stgcan_block, fused_backbone): {launches}")
    return {"fused": {"flagship": dict(flagship, served=served), "sync_free_chunk": sync,
                      "musa": musa_row, "cv_vmapped": cv_row, "blocks": blocks,
                      "kernel_launches": launches, "phase_s": phase_s, "card": card}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; defaults: "
        f"matmul.allow_tf32={defaults[0]} cudnn.allow_tf32={defaults[1]}")

    # ---- phase 1: build every kernel from source ---------------------------
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report) or 'cached'}")
    for name, info in report.items():
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    rng = np.random.default_rng(SEED)
    sd_random = seeded_state_dict(cfg)
    pred = Predictor(cfg, sd_random, batch_size=BATCH, device=dev)
    calls = block_shapes(pred)

    # ---- phase 1b: the main path under PyTorch's default TF32 switches ------
    # cuDNN may use TF32 by default (the sensor head is Conv1d + LSTM); the
    # Predictor switches it off for its own modules and restores the caller's.
    d = cfg.data
    skel = rng.normal(size=(BATCH, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(BATCH, d.seq_len, d.sensor_dim)).astype(np.float32)
    cpu_logits = Predictor(cfg, sd_random, batch_size=BATCH, device="cpu").predict_logits(
        skel, sens)
    torch.backends.cudnn.allow_tf32 = True
    err_default = float(np.abs(pred.predict_logits(skel, sens) - cpu_logits).max())
    after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"main path under default flags (cudnn.allow_tf32=True): logits vs CPU "
        f"max_abs_err={err_default:.3e}; flags after the call {after}")
    if not err_default <= MODEL_TOL or after != (defaults[0], True):
        raise AssertionError(f"served logits under default TF32 flags are off by "
                             f"{err_default} or the caller's flags changed: {after}")
    # the plain versions below are float32 references: TF32 off from here on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2: the kernel against its plain version, every shape --------
    distinct = {}
    for stream, i, t, folded, stride, mode in calls:
        cin = folded.gcn_w.shape[0]
        key = (cin, folded.bn1_scale.shape[0], t, stride, mode)
        distinct.setdefault(key, []).append((stream, i, folded))
    max_err = 0.0
    per_shape = {}
    emulated = set()
    for key, users in distinct.items():
        cin, c, t, stride, mode = key
        folded = users[0][2]
        for n in (BATCH, 1, 37):
            x = torch.from_numpy(rng.normal(size=(n, t, 14, cin)).astype(np.float32)).to(dev)
            out = fused_stgcan_block(x, folded, stride=stride, residual_mode=mode)
            torch.cuda.synchronize()
            ref = stgcan_block_reference(x, folded, stride, mode)
            err = (out - ref).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= KERNEL_TOL
            log(f"check stgcan_block Cin={cin} C={c} T={t} stride={stride} {mode:8s} "
                f"N={n:3d}: max_abs_err={err:.3e} ({'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(f"stgcan_block disagrees at {key}, N={n}: {err}")
            max_err = max(max_err, err)
            if n == BATCH:
                per_shape[key] = x
        if cin == c and c not in emulated:
            # one shape per width: the kernel against the emulation of its arithmetic
            emulated.add(c)
            emu = (out - stgcan_block_emulated(x, folded, stride, mode)).abs().max().item()
            log(f"      stgcan_block C={c}: vs the split-TF32 emulation max_abs_err={emu:.3e} "
                f"(vs the fp32 plain version {err:.3e})")

    # ---- phase 2b: the whole-backbone kernel against its plain version ------
    # full width for default_urfall (2 classes) and default (11 classes), and
    # the short two-block plan; tolerance KERNEL_TOL absolute on the logits
    cfg_s = load_config(preset_path("default_urfall"))
    sd_s = seeded_state_dict(cfg_s)
    pred_s = Predictor(cfg_s, sd_s, batch_size=BATCH, device=dev)
    cfg_h = load_config(preset_path("default"))
    cfg_short = cfg_s.replace(model=dataclasses.replace(
        cfg_s.model, kwargs={"stages": SHORT_PLAN}))
    backbones = {"default_urfall": pred_s.folded}
    for name, c in (("default", cfg_h), ("short_plan", cfg_short)):
        backbones[name] = Predictor(c, seeded_state_dict(c), batch_size=BATCH,
                                    device=dev).folded
    ds = cfg_s.data
    bb_err = 0.0
    for name, folded in backbones.items():
        for n in (BATCH, 1, 37):
            x = torch.from_numpy(rng.normal(
                size=(n, ds.seq_len, ds.num_joints, ds.in_channels)).astype(np.float32)).to(dev)
            out = fused_backbone_forward(x, folded)
            torch.cuda.synchronize()
            ref = fused_backbone_reference(x, folded)
            err = (out - ref).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= KERNEL_TOL \
                and out.shape == (n, folded.cls_b.shape[0])
            log(f"check fused_backbone {name} blocks={len(folded.blocks)} "
                f"classes={folded.cls_b.shape[0]} N={n:3d}: max_abs_err={err:.3e} "
                f"(|logit| max {ref.abs().max().item():.3f}; {'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(f"fused_backbone disagrees on {name}, N={n}: {err}")
            bb_err = max(bb_err, err)

    # ---- phase 3: the reference checkpoint served on the card --------------
    sd_ref = load_state_dict_file(FIXTURE)
    g = np.load(FIXTURE)
    ref_pred = Predictor(cfg, sd_ref, batch_size=BATCH, device=dev)
    skel_fx = np.ascontiguousarray(np.transpose(g["x"], (0, 2, 3, 1)))
    proba = ref_pred.predict_proba(skel_fx, g["sensor"])
    err_fx = float(np.abs(proba - g["out"]).max())
    log(f"reference checkpoint: softmax vs fixture out max_abs_err={err_fx:.3e}")
    if not err_fx <= MODEL_TOL:
        raise AssertionError(f"reference checkpoint output off by {err_fx}")

    # ---- phase 4: the main path, seeded weights, batch 128 -----------------
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    logits = pred.predict_logits(skel, sens)
    launches = fused_stgcan_block.launches
    log(f"main path: Predictor(batch {BATCH}) forward launched stgcan_block {launches} times")
    if launches != len(calls) or launches != 14 or fused_backbone_forward.launches:
        raise AssertionError(f"expected 14 stgcan_block launches per forward, saw {launches}")
    err_cpu = float(np.abs(logits - cpu_logits).max())
    log(f"main path logits {logits.shape}, finite={np.isfinite(logits).all()}, "
        f"vs CPU max_abs_err={err_cpu:.3e} (|logits| max {np.abs(logits).max():.3f})")
    if logits.shape != (BATCH, d.num_classes) or not np.isfinite(logits).all() \
            or not err_cpu <= MODEL_TOL:
        raise AssertionError(f"main path logits disagree with the CPU run: {err_cpu}")

    # ---- phase 4b: the single-stream stgcan path, one launch per forward ----
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    logits_s = pred_s.predict_logits(skel)
    bb_launches, k1_launches = fused_backbone_forward.launches, fused_stgcan_block.launches
    log(f"stgcan path: Predictor(batch {BATCH}) forward launched fused_backbone "
        f"{bb_launches} time(s), stgcan_block {k1_launches} times")
    if bb_launches != 1 or k1_launches != 0:
        raise AssertionError(f"expected 1 fused_backbone and 0 stgcan_block launches per "
                             f"stgcan forward, saw {bb_launches} and {k1_launches}")
    cpu_s = Predictor(cfg_s, sd_s, batch_size=BATCH, device="cpu").predict_logits(skel)
    err_s = float(np.abs(logits_s - cpu_s).max())
    log(f"stgcan path logits {logits_s.shape}, finite={np.isfinite(logits_s).all()}, "
        f"vs CPU max_abs_err={err_s:.3e} (|logits| max {np.abs(logits_s).max():.3f})")
    if logits_s.shape != (BATCH, ds.num_classes) or not np.isfinite(logits_s).all() \
            or not err_s <= MODEL_TOL:
        raise AssertionError(f"stgcan path logits disagree with the CPU run: {err_s}")

    # ---- phase 4c: two_stgcan, both streams through the block kernel --------
    cfg_t = load_config(preset_path("twostream_stgcan"))
    sd_t = seeded_state_dict(cfg_t)
    pred_t = Predictor(cfg_t, sd_t, batch_size=BATCH, device=dev)
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    logits_t = pred_t.predict_logits(skel)
    if fused_stgcan_block.launches != 14 or fused_backbone_forward.launches:
        raise AssertionError(f"expected 14 stgcan_block launches per two_stgcan forward, saw "
                             f"{fused_stgcan_block.launches}")
    cpu_t = Predictor(cfg_t, sd_t, batch_size=BATCH, device="cpu").predict_logits(skel)
    err_t = float(np.abs(logits_t - cpu_t).max())
    log(f"two_stgcan logits {logits_t.shape}: 14 stgcan_block launches, vs CPU "
        f"max_abs_err={err_t:.3e} (|logits| max {np.abs(logits_t).max():.3f})")
    if logits_t.shape != (BATCH, cfg_t.data.num_classes) or not err_t <= MODEL_TOL:
        raise AssertionError(f"two_stgcan logits disagree with the CPU run: {err_t}")

    # ---- phase 5: the HTTP server ------------------------------------------
    srv = PredictionServer(pred, host="127.0.0.1", port=0).start()
    try:
        health = http_json(f"http://127.0.0.1:{srv.port}/healthz")
        if health.get("status") != "ok":
            raise AssertionError(f"healthz answered {health}")
        for n in (1, 5, 200):
            sk, se = (rng.normal(size=(n, d.seq_len, d.num_joints, d.in_channels)).astype(
                np.float32), rng.normal(size=(n, d.seq_len, d.sensor_dim)).astype(np.float32))
            got = http_json(f"http://127.0.0.1:{srv.port}/v1/predict",
                            {"skeleton": sk.tolist(), "sensor": se.tolist(), "proba": True})
            want = pred.predict_proba(sk, se)
            err = float(np.abs(np.asarray(got["probabilities"]) - want).max())
            log(f"server: POST {n} windows -> n={got['n']}, max_abs_err={err:.3e}")
            if got["n"] != n or got["predictions"] != want.argmax(-1).tolist() or err > 1e-6:
                raise AssertionError(f"server answer for {n} windows disagrees ({err})")
    finally:
        srv.close()
    srv = PredictionServer(pred_s, host="127.0.0.1", port=0).start()
    try:
        health = http_json(f"http://127.0.0.1:{srv.port}/healthz")
        if health.get("status") != "ok" or health.get("requires_sensor") is not False:
            raise AssertionError(f"stgcan healthz answered {health}")
        sk = rng.normal(size=(5, ds.seq_len, ds.num_joints, ds.in_channels)).astype(np.float32)
        got = http_json(f"http://127.0.0.1:{srv.port}/v1/predict",
                        {"skeleton": sk.tolist(), "proba": True})       # no "sensor" key
        want = pred_s.predict_proba(sk)
        err = float(np.abs(np.asarray(got["probabilities"]) - want).max())
        log(f"server (stgcan): POST 5 windows without a sensor -> n={got['n']}, "
            f"max_abs_err={err:.3e}")
        if got["n"] != 5 or got["predictions"] != want.argmax(-1).tolist() or err > 1e-6:
            raise AssertionError(f"stgcan server answer disagrees ({err})")
    finally:
        srv.close()

    # ---- phase 6: timings ----------------------------------------------------
    kernel_ms = plain_ms = bound_ms = fma_bound_ms = lib_fp32_ms = lib_tf32_ms = 0.0
    k1_by = set()
    uses = {}
    for stream, i, t, folded, stride, mode in calls:
        key = (folded.gcn_w.shape[0], folded.bn1_scale.shape[0], t, stride, mode)
        uses[key] = uses.get(key, 0) + 1
    for key, x in per_shape.items():
        cin, c, t, stride, mode = key
        folded = distinct[key][0][2]
        k_ms = cuda_ms(lambda: fused_stgcan_block(x, folded, stride, mode))
        p_ms = cuda_ms(lambda: stgcan_block_reference(x, folded, stride, mode))
        gemm, other, nbytes = block_cost(BATCH, t, 14, cin, folded, stride, mode)
        b_ms, by, fma_ms = bounds_ms(gemm, other, nbytes)
        lib32, libtf = tap_gemm_library_ms(BATCH, (t - 1) // stride + 1, 14, c)
        log(f"time stgcan_block Cin={cin} C={c} T={t} stride={stride} {mode:8s} N={BATCH} "
            f"x{uses[key]}/forward: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({by}, 3xTF32 tensor cores; fp32-FMA bound {fma_ms:.4f} ms; "
            f"{(gemm + other) / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"{(gemm + other) / k_ms / 1e9:.1f} TFLOP/s, "
            f"{kernel_smem_bytes(t, 14, 3, c, stride) / 1024:.1f} KB shared memory a CTA; "
            f"gemm_library_ms (torch.matmul, taps only) fp32 {lib32:.4f}, TF32 {libtf:.4f}")
        kernel_ms += uses[key] * k_ms
        plain_ms += uses[key] * p_ms
        bound_ms += uses[key] * b_ms
        fma_bound_ms += uses[key] * fma_ms
        lib_fp32_ms += uses[key] * lib32
        lib_tf32_ms += uses[key] * libtf
        k1_by.add(by)
    log(f"stgcan_block per forward (14 launches, batch {BATCH}): kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (fp32-FMA bound "
        f"{fma_bound_ms:.4f} ms), gemm_library_ms fp32 {lib_fp32_ms:.4f}, TF32 {lib_tf32_ms:.4f}")

    skel_d = torch.from_numpy(skel).to(dev)
    sens_d = torch.from_numpy(sens).to(dev)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.forward(skel_d, sens_d))
    for _ in range(3):
        pred.predict_logits(skel, sens)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_logits(skel, sens)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    log(f"Predictor batch {BATCH}: device {fwd_ms:.3f} ms/forward (events), "
        f"host {host_ms:.3f} ms/call incl. copies -> {BATCH / host_ms * 1e3:.0f} windows/s")
    lat = measure_push_latency(StreamingClassifier(pred, seq_len=d.seq_len), n_pushes=50,
                               warmup=5, sensor_dim=d.sensor_dim)
    log(f"streaming push latency (batch 1, {lat['n']} pushes): p50 {lat['p50_ms']:.3f} ms, "
        f"p99 {lat['p99_ms']:.3f} ms")

    # the whole-backbone kernel and the stgcan path
    x_s = torch.from_numpy(skel).to(dev)
    folded_s = pred_s.folded
    blockwise = FusedBackbone(pred_s.model)      # the same backbone, one launch per block
    bb_ms = cuda_ms(lambda: fused_backbone_forward(x_s, folded_s))
    bb_plain_ms = cuda_ms(lambda: fused_backbone_reference(x_s, folded_s))
    k1x7_ms = cuda_ms(lambda: blockwise(x_s))
    bb_gemm, bb_other, bb_bytes = backbone_cost(BATCH, ds.seq_len, ds.num_joints,
                                                ds.in_channels, folded_s)
    bb_flops = bb_gemm + bb_other
    bb_bound_ms, bb_by, bb_fma_ms = bounds_ms(bb_gemm, bb_other, bb_bytes)
    bb_lib32 = bb_libtf = 0.0
    tt = ds.seq_len
    for block, (stride, _) in zip(folded_s.blocks, folded_s.stage_plan):
        tt = (tt - 1) // stride + 1
        lib32, libtf = tap_gemm_library_ms(BATCH, tt, ds.num_joints, block.bn1_scale.shape[0])
        bb_lib32, bb_libtf = bb_lib32 + lib32, bb_libtf + libtf
    log(f"time fused_backbone default_urfall N={BATCH}: kernel {bb_ms:.4f} ms (1 launch), "
        f"plain {bb_plain_ms:.4f} ms, the same backbone in 7 stgcan_block launches "
        f"{k1x7_ms:.4f} ms, bound {bb_bound_ms:.4f} ms ({bb_by}, 3xTF32 tensor cores; "
        f"fp32-FMA bound {bb_fma_ms:.4f} ms; {bb_flops / 1e9:.3f} GFLOP, "
        f"{bb_bytes / 1e6:.2f} MB), {bb_flops / bb_ms / 1e9:.1f} TFLOP/s; gemm_library_ms "
        f"(torch.matmul, the 7 tap GEMMs only) fp32 {bb_lib32:.4f}, TF32 {bb_libtf:.4f}")
    x_1 = x_s[:1].contiguous()
    bb1_ms = cuda_ms(lambda: fused_backbone_forward(x_1, folded_s))
    log(f"time fused_backbone default_urfall N=1: kernel {bb1_ms:.4f} ms, 7 stgcan_block "
        f"launches {cuda_ms(lambda: blockwise(x_1)):.4f} ms")
    for _ in range(3):
        pred_s.predict_logits(skel)
    t0 = time.perf_counter()
    for _ in range(reps):
        pred_s.predict_logits(skel)
    host_s_ms = (time.perf_counter() - t0) * 1e3 / reps
    log(f"stgcan Predictor batch {BATCH}: host {host_s_ms:.3f} ms/call incl. copies -> "
        f"{BATCH / host_s_ms * 1e3:.0f} windows/s")
    lat_s = measure_push_latency(StreamingClassifier(pred_s, seq_len=ds.seq_len), n_pushes=50,
                                 warmup=5)
    log(f"stgcan streaming push latency (batch 1, {lat_s['n']} pushes): "
        f"p50 {lat_s['p50_ms']:.3f} ms, p99 {lat_s['p99_ms']:.3f} ms; host share of a push "
        f"(p50 - batch-1 kernel): {lat_s['p50_ms'] - bb1_ms:.3f} ms, before the constants "
        f"were packed once: {HOST_SHARE_BEFORE_MS:.3f} ms")

    # ---- phase 7: training at full width, then the trained weights served ----
    train_7a = train_steps_card_vs_cpu(cfg, sd_random, dev, defaults)
    train_7b = [train_then_serve("gstcan_urfall_3stream", 3, dev, k1_per_forward=14,
                                 k2_per_forward=0),
                train_then_serve("default_urfall", 2, dev, k1_per_forward=0, k2_per_forward=1)]
    train_rows = train_timings(dev, card)

    # ---- phase 8: the Gen-3 and Gen-1 families, k-copies through the kernels ----
    t8 = time.perf_counter()
    fixtures_8a = serve_fixtures(dev, defaults)
    families_8b = serve_families(dev, rng)
    k_copies_8c, k1_err_15, k2_err_15 = k_copies_through_the_kernels(dev, rng, cfg, sd_random,
                                                                     cfg_s, sd_s)
    served_8d, train_8d = train_families(dev, card)
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")
    max_err, bb_err = max(max_err, k1_err_15), max(bb_err, k2_err_15)

    # ---- phase 9: k-fold CV and grid search through the CLIs, folds served ----
    cv_9 = cv_phase(dev, defaults, card)

    # ---- phase 10: fold-parallel CV and data parallelism ---------------------
    cv_10 = cv_parallel_phase(dev, defaults, card)

    # ---- phase 11: fused epochs, the blocks no preset builds -----------------
    fused_11 = fused_phase(dev, card)

    log(json.dumps({"train": train_rows, "steps_card_vs_cpu": train_7a,
                    "train_then_serve": train_7b}))
    log(json.dumps({"families": families_8b, "fixtures": fixtures_8a, "k_copies": k_copies_8c,
                    "train_then_serve": served_8d, "train": train_8d, "card": card}))
    log(json.dumps(cv_9))
    log(json.dumps(cv_10))
    log(json.dumps(fused_11))
    log(json.dumps({"kernels": [{
        "name": "stgcan_block",
        "route": "cuda",
        "source": "fall_multimodal_tpu_torch/ops/csrc/stgcan_block.cu",
        "replaces": "fall_multimodal_tpu/ops/pallas/stgcan_block.py:62",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if k1_by == {"operations"} else "bytes",
        "bound_pipe": "3xTF32 tensor cores",
        "fma_bound_ms": fma_bound_ms,
        "gemm_library_ms": {"fp32": lib_fp32_ms, "tf32": lib_tf32_ms},
        "library_ms": None,
    }, {
        "name": "fused_backbone",
        "route": "cuda",
        "source": "fall_multimodal_tpu_torch/ops/csrc/fused_backbone.cu",
        "replaces": "fall_multimodal_tpu/ops/pallas/fused_backbone_v2.py:212",
        "launches": bb_launches,
        "max_abs_err": bb_err,
        "ms": bb_ms,
        "plain_ms": bb_plain_ms,
        "bound_ms": bb_bound_ms,
        "bound_by": bb_by,
        "bound_pipe": "3xTF32 tensor cores",
        "fma_bound_ms": bb_fma_ms,
        "gemm_library_ms": {"fp32": bb_lib32, "tf32": bb_libtf},
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
