"""The general generators: each reads a traffic file's parameters, makes
the inputs and weights from the seed, drives the system under test through
the window, and compares what the window produced with the plain reference.

* ``closed_batches``: back-to-back ``Predictor.predict_logits`` calls on
  host windows, cycling through a pool of distinct batches; every answer of
  the window is compared.
* ``train_job``: the preset's training job through ``fit`` with a
  checkpointer, on device-resident windows, at the configuration's batch or
  the one the traffic names (``batch_size``), stopped at the first epoch end
  after the window; the state it trains took its first steps in set-up,
  and those are compared step by step.

Each generator is split into its stages so that the control and the planted
faults (``port_bench/calibrate.py``) run the same code.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.harness import checks, core, data
from port_bench.harness.core import Ctx, Outcome, float32
from port_bench.harness.weights import seed_weights


def _to(x: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _peak(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def trained_weights(ctx: Ctx, pose: np.ndarray, sensor: Optional[np.ndarray]) -> Dict:
    """Seeded 'trained' weights under the reference's names, conditioned on
    one batch, on the host."""
    family = core.reference(ctx.cell)
    ref = family.build(ctx.model).to(ctx.device)
    with float32():
        sd = seed_weights(ref, ctx.seed, "trained",
                          condition=(_to(pose, ctx.device), _to(sensor, ctx.device)),
                          reference=family)
    return {k: v.cpu() for k, v in sd.items()}


def reference_logits(ctx: Ctx, weights: Dict, pose: np.ndarray, sensor: Optional[np.ndarray],
                     tf32: bool = False, batch: int = 128) -> np.ndarray:
    """The plain reference's logits of ``(N, T, V, C)`` windows, in blocks of
    ``batch``; ``tf32`` computes them in TF32 (the control)."""
    ref = core.reference(ctx.cell).build(ctx.model)
    ref.load_state_dict(weights)
    ref = ref.to(ctx.device).eval()
    out = []
    with torch.no_grad(), float32(tf32):
        for s in range(0, len(pose), batch):
            sen = None if sensor is None else _to(sensor[s:s + batch], ctx.device)
            out.append(ref(_to(pose[s:s + batch], ctx.device), sen).double().cpu().numpy())
    del ref
    return np.concatenate(out)


# ---------------------------------------------------------------- closed batches

class ClosedBatches:
    def __init__(self, ctx: Ctx):
        from fall_multimodal_tpu_torch.serve import Predictor

        self.ctx = ctx
        m, tr = ctx.model, ctx.traffic
        self.batch, self.pool = int(tr["batch"]), int(tr["pool_batches"])
        w = data.make_windows(self.batch * self.pool, m["seq_len"], m["num_joints"],
                              m["num_classes"], m["sensor_dim"] if m["uses_sensor"] else 0,
                              tr["noise"], ctx.seed)
        self.pose = w.pose.reshape(self.pool, self.batch, *w.pose.shape[1:])
        self.sensor = None if w.sensor is None else \
            w.sensor.reshape(self.pool, self.batch, *w.sensor.shape[1:])
        ctx.mark("inputs")
        self.weights = trained_weights(ctx, self.pose[0], self._sensor(0))
        ctx.mark("weights")
        self.predictor = Predictor(core.port_config(ctx.config), self.weights,
                                   batch_size=self.batch, device=ctx.device)
        ctx.mark("system")
        for i in range(min(2, self.pool)):       # the one shape this traffic uses
            self.predictor.predict_logits(self.pose[i], self._sensor(i))
        ctx.mark("warm-up")
        self.answers: List[np.ndarray] = []

    def _sensor(self, i: int) -> Optional[np.ndarray]:
        return None if self.sensor is None else self.sensor[i]

    def window(self) -> Dict:
        ctx, pred = self.ctx, self.predictor
        t0 = ctx.open_window()
        ctx.start_trace()
        calls = traced = 0
        while True:
            i = calls % self.pool
            with ctx.tracer.span("predict"):
                self.answers.append(pred.predict_logits(self.pose[i], self._sensor(i)))
            calls += 1
            traced += ctx.tracer.active
            now = time.perf_counter()
            if ctx.tracer.active and now - ctx.trace_t0 >= ctx.traffic["trace_seconds"]:
                ctx.stop_trace()
            if now - t0 >= ctx.seconds:
                break
        ctx.stop_trace()
        ctx.close_window()
        return {"window_s": now - t0, "windows": calls * self.batch, "calls": calls,
                "traced_windows": traced * self.batch}

    def free_program(self) -> int:
        peak = _peak(self.ctx.device)
        del self.predictor
        free_device(self.ctx.device)
        return peak

    def reference(self, tf32: bool = False) -> np.ndarray:
        """``(pool, batch, classes)`` reference logits of the pool."""
        n = min(len(self.answers), self.pool) if self.answers else self.pool
        pose = self.pose[:n].reshape(-1, *self.pose.shape[2:])
        sensor = None if self.sensor is None else self.sensor[:n].reshape(
            -1, *self.sensor.shape[2:])
        return reference_logits(self.ctx, self.weights, pose, sensor, tf32, self.batch) \
            .reshape(n, self.batch, -1)

    def compare(self, answers: List[np.ndarray], ref: np.ndarray) -> Dict:
        shaped = [a for a in answers if np.shape(a) == ref.shape[1:]]
        failed = self.batch * (len(answers) - len(shaped))
        failed += int(sum((~np.isfinite(a)).any(axis=-1).sum() for a in shaped))
        if not shaped:
            return {"failed": failed, "logit_gap": float("inf")}
        idx = [i % len(ref) for i, a in enumerate(answers) if np.shape(a) == ref.shape[1:]]
        gap = checks.logit_gap(np.concatenate(shaped), np.concatenate([ref[i] for i in idx]))
        return {"failed": failed, "logit_gap": gap}


def closed_batches(ctx: Ctx) -> Outcome:
    run = ClosedBatches(ctx)
    host = run.window()
    peak = run.free_program()
    result = run.compare(run.answers, run.reference())
    return Outcome(attempted=host["windows"], failed=result["failed"], host=host,
                   checks={"logit_gap": result["logit_gap"]}, memory_peak_bytes=peak)


# ---------------------------------------------------------------- train job

class WindowClosed(Exception):
    """Raised from the epoch callback at the first epoch end after the window."""


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def running_stats(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


class TrainJob:
    """Set-up builds the one train state, takes its first ``checked_steps``
    steps through the epoch function ``fit`` uses and records what the
    reference is held to; the window hands that same state to ``fit``."""

    def __init__(self, ctx: Ctx):
        from fall_multimodal_tpu_torch.data.pipeline import to_device
        from fall_multimodal_tpu_torch.data.synthetic import WindowedDataset
        from fall_multimodal_tpu_torch.train.loop import (evaluate, make_eval_epoch,
                                                          make_train_epoch)
        from fall_multimodal_tpu_torch.train.optim import build_optimizer
        from fall_multimodal_tpu_torch.train.state import create_train_state

        self.ctx = ctx
        m, tr = ctx.model, ctx.traffic
        self.batch = int(tr.get("batch_size", ctx.config["train"]["batch_size"]))
        self.cfg = cfg = core.port_config(
            core.deep_merge(ctx.config, {"train": {"batch_size": self.batch}}))
        w = data.make_windows(int(tr["windows"]), m["seq_len"], m["num_joints"],
                              m["num_classes"], m["sensor_dim"] if m["uses_sensor"] else 0,
                              tr["noise"], ctx.seed, int(tr["windows_per_video"]))
        self.w = w
        self.split = data.split_by_video(w.videos, tuple(tr["split"]), ctx.seed)
        self.splits = {k: to_device(WindowedDataset(
            features=w.pose[idx], labels=w.labels[idx],
            sensors=None if w.sensor is None else w.sensor[idx], videos=w.videos[idx]),
            ctx.device) for k, idx in self.split.items()}
        ctx.mark("inputs")
        self.steps_per_epoch = max(1, self.splits["train"].n // self.batch)
        family = core.reference(ctx.cell)
        ref = family.build(m).to(ctx.device)
        self.weights = {k: v.cpu() for k, v in seed_weights(
            ref, ctx.seed, "init", reference=family).items()}
        del ref
        optimizer = build_optimizer(cfg.optim, scheduler=cfg.lr_scheduler,
                                    steps_per_epoch=self.steps_per_epoch,
                                    max_norm=cfg.train.max_norm, accum_iter=cfg.train.accum_iter)
        self.state = create_train_state(cfg, optimizer, seed=cfg.seed,
                                        weight_init=cfg.model.weight_init, device=ctx.device)
        self.state.model.load_state_dict({k: v.to(ctx.device) for k, v in self.weights.items()})
        ctx.mark("weights and system")
        # the first steps, on rows that all differ, through fit's own functions
        k = int(tr["checked_steps"])
        rows = np.random.default_rng([ctx.seed, 2]).permutation(self.splits["train"].n)
        self.rows = rows[:k * self.batch].reshape(k, self.batch)
        train_epoch = make_train_epoch(cfg.train.label_smoothing, cfg.model.softmax_output)
        eval_epoch = make_eval_epoch(m["num_classes"], cfg.train.label_smoothing,
                                     cfg.model.softmax_output)
        self.program = {"eval_loss": evaluate(eval_epoch, self.state, self.splits["valid"],
                                              self.batch).loss, "loss": []}
        named = dict(self.state.model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        for i in range(k):
            idx = torch.as_tensor(self.rows[i:i + 1], device=ctx.device)
            _, metrics = train_epoch(self.state, self.splits["train"], idx)
            self.program["loss"].append(float(metrics["loss"]))
            if i == 0:
                self.program["grad"] = self._first_gradient_norms(named)
                self.program["stats"] = running_stats(self.state.model)
        self.program["change"] = _norms({n: p.detach() - start[n] for n, p in named.items()})
        del start
        ctx.mark("checked steps")

    def _first_gradient_norms(self, named: Dict[str, torch.nn.Parameter]) -> Dict[str, float]:
        """Each leaf's first gradient as the optimizer took it, from RMSprop's
        state after one step: ``square_avg = (1 - alpha) * g^2``."""
        opt = self.state.optimizer
        alpha = self.ctx.config["optim"]["rms_decay"]
        by_id = {id(p): n for n, p in named.items()}
        out = {n: 0.0 for n in named}
        for p in opt.params:
            st = opt.inner.state.get(p, {})
            if "square_avg" in st:
                out[by_id[id(p)]] = float(torch.sqrt(st["square_avg"].double().sum()
                                                     / (1 - alpha)))
        return out

    def window(self) -> Dict:
        from fall_multimodal_tpu_torch.train.loop import fit
        from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

        ctx, cfg = self.ctx, self.cfg
        tracer = ctx.tracer

        saves = {"best": 0, "latest": 0, "seconds": 0.0}

        def timed(name, save):
            def wrapped(*a, **k):
                start = time.perf_counter()
                with tracer.span("checkpoint"):
                    save(*a, **k)
                saves[name] += 1
                saves["seconds"] += time.perf_counter() - start
            return wrapped

        class SpannedCheckpointer(Checkpointer):
            def __init__(self, directory):
                super().__init__(directory)
                self.save_best = timed("best", super().save_best)
                self.save_latest = timed("latest", super().save_latest)

        epochs, ends = [0], []

        def callback(epoch, scalars):
            ends.append(time.perf_counter())
            epochs[0] += 1
            if tracer.active and epochs[0] == ctx.traffic["trace_epochs"]:
                ctx.stop_trace()
            if ends[-1] - t0 >= ctx.seconds:
                raise WindowClosed

        self.nan = False
        with tempfile.TemporaryDirectory(prefix="port_bench_ckpt_") as ckpt:
            t0 = ctx.open_window()
            ctx.start_trace()
            try:
                while True:        # a job that ends inside the window starts again
                    result = fit(self.state, self.splits, epochs=cfg.train.epochs,
                        batch_size=self.batch, num_classes=ctx.model["num_classes"],
                        label_smoothing=cfg.train.label_smoothing,
                        softmax_before_ce=cfg.model.softmax_output,
                        drop_last=cfg.train.drop_last, shuffle_seed=cfg.seed,
                        checkpointer=SpannedCheckpointer(os.path.join(ckpt, "fold0")),
                        metrics_callback=callback, epoch_impl=cfg.train.epoch_impl,
                        scan_epochs=cfg.train.scan_epochs)
                    # fit stops at a non-finite train loss and keeps the best state
                    self.nan = not np.isfinite(result.history["train_loss"]).all()
                    if self.nan or time.perf_counter() - t0 >= ctx.seconds:
                        break
            except WindowClosed:
                pass
            ctx.stop_trace()
            ctx.close_window()
            written = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, fs in os.walk(ckpt) for f in fs)
        per_epoch = self.steps_per_epoch * self.batch
        end = ends[-1] if ends else time.perf_counter()
        return {"window_s": end - t0, "epochs": epochs[0], "checkpoints": saves,
                "epoch_s": np.diff([t0] + ends).round(4).tolist(),
                "train_windows": epochs[0] * per_epoch,
                "traced_steps": min(epochs[0], ctx.traffic["trace_epochs"]) * self.steps_per_epoch,
                "traced_windows": min(epochs[0], ctx.traffic["trace_epochs"]) * per_epoch,
                "checkpoint_bytes_at_end": written}

    def free_program(self) -> int:
        peak = _peak(self.ctx.device)
        del self.state, self.splits
        free_device(self.ctx.device)
        return peak

    def reference(self, tf32: bool = False, loss_fn=None, dtype=torch.float32) -> Dict:
        """The reference's readings of the same steps from the same weights:
        the eval loss before the first step, each step's loss, each leaf's
        first gradient norm, the running statistics after the first step and
        each leaf's change after the last. ``tf32``, ``loss_fn`` and
        ``dtype`` make the control, the planted faults and a float64 witness."""
        ctx, m = self.ctx, self.ctx.model
        family = core.reference(ctx.cell)
        step_ref = core.reference(ctx.cell, "step_reference")
        model = family.build(m)
        model.load_state_dict(self.weights)
        model = model.to(ctx.device, dtype)
        trainer = step_ref.Trainer(model, ctx.config["optim"], ctx.config["train"],
                                   ctx.config["train"]["softmax_output"], loss_fn=loss_fn)
        w = self.w

        def dev(x):
            return _to(x, ctx.device).to(dtype)

        sensor = w.sensor if w.sensor is not None else np.zeros((len(w.pose), 1, 1), np.float32)
        out = {"loss": []}
        with float32(tf32):
            valid = self.split["valid"]
            model.eval()
            with torch.no_grad():
                total = 0.0
                for s in range(0, len(valid), self.batch):
                    idx = valid[s:s + self.batch]
                    logits = model(dev(w.pose[idx]), dev(sensor[idx]))
                    if ctx.config["train"]["softmax_output"]:
                        logits = torch.softmax(logits, -1)
                    target = dev(w.labels[idx])
                    total += float((-(target * torch.log_softmax(logits, -1)).sum(-1)).sum())
            out["eval_loss"] = total / len(valid)
            train = self.split["train"]
            start = {n: p.detach().clone() for n, p in trainer.params.items()}
            for i, rows in enumerate(self.rows):
                idx = train[rows]
                loss, grads = trainer.step(dev(w.pose[idx]), dev(sensor[idx]),
                                           dev(w.labels[idx]))
                out["loss"].append(loss)
                if i == 0:
                    out["grad"] = _norms(grads)
                    out["stats"] = running_stats(model)
            out["change"] = _norms({n: p.detach() - start[n]
                                    for n, p in trainer.params.items()})
        return out

    @staticmethod
    def compare(program: Dict, ref: Dict) -> Dict[str, float]:
        keep = [n for n in ref["change"] if n not in checks.quiet_leaves(ref["grad"])]
        stats_p = {k: v.to("cpu") for k, v in program["stats"].items()}
        stats_r = {k: v.to("cpu") for k, v in ref["stats"].items()}
        grad, grad_leaf = checks.norm_gap(program["grad"], ref["grad"])
        change, change_leaf = checks.norm_gap(program["change"], ref["change"], keep)
        stats, stats_leaf = checks.value_gap(stats_p, stats_r)
        return {
            "first_loss_gap": checks.relative_gap(program["loss"][:1], ref["loss"][:1]),
            "grad_gap": grad, "change_gap": change, "stats_gap": stats,
            "readings": {
                "loss_gap": checks.relative_gap(program["loss"], ref["loss"]),
                "eval_gap": checks.relative_gap([program["eval_loss"]], [ref["eval_loss"]]),
                "grad_leaf": grad_leaf, "change_leaf": change_leaf, "stats_leaf": stats_leaf,
                "losses": program["loss"], "reference_losses": ref["loss"]},
        }


def train_job(ctx: Ctx) -> Outcome:
    run = TrainJob(ctx)
    host = run.window()
    peak = run.free_program()
    numbers = run.compare(run.program, run.reference())
    notes = [f"train: {host['epochs']} epochs of {run.steps_per_epoch} steps in "
             f"{host['window_s']:.3f} s; {host['checkpoint_bytes_at_end']} checkpoint bytes "
             f"on disk at the end; saves {host['checkpoints']}; epoch seconds {host['epoch_s']}",
             f"train readings not compared: {numbers.pop('readings')}"]
    # an epoch whose loss goes non-finite ends the job: its windows failed
    failed = run.steps_per_epoch * run.batch if run.nan else 0
    return Outcome(attempted=host["train_windows"] + failed, failed=failed,
                   host=host, checks=numbers, memory_peak_bytes=peak, notes=notes)


GENERATORS = {"closed_batches": closed_batches, "train_job": train_job}
