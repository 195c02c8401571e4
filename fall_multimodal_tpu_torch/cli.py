"""Command-line trainer of the port (counterpart of the JAX package's
``cli.py``): a single run, k-fold cross-validation or a grid search.

    python -m fall_multimodal_tpu_torch.cli --config gstcan_urfall_3stream \\
        --set optim.lr=5e-4 --set train.epochs=50 --output-dir outputs/run1
    python -m fall_multimodal_tpu_torch.cli --config gstcan_urfall_3stream --cv --folds 10
    python -m fall_multimodal_tpu_torch.cli --config gstcan_urfall_3stream --cv-vmapped --folds 5
    torchrun --nproc-per-node 2 -m fall_multimodal_tpu_torch.cli \\
        --config gstcan_urfall_3stream --distributed --mesh 2
    python -m fall_multimodal_tpu_torch.cli --config musa_harup --grid   # 48 points
    python -m fall_multimodal_tpu_torch.cli --config gstcan_urfall_3stream \\
        --device cpu --set train.epochs=1 --set train.batch_size=8 \\
        --synthetic-windows 64

Trains on the card (``--device cuda``, the default) unless ``--device cpu``
is passed, and writes under the output dir ``config.json`` and ``log.txt``,
and then:

* a single run: ``history.json`` (per-epoch curves), ``report.txt``
  (classification report of the test split on the best state) and
  ``ckpt/{best,latest}/checkpoint.pt``
  (:mod:`fall_multimodal_tpu_torch.utils.checkpoint`). The output dir is
  never wiped, so ``--resume <out>/ckpt`` continues a run at its saved epoch
  and ``--test-only`` evaluates ``best``;
* ``--cv``: ``cv_results.json`` (per-fold rows and their mean/std),
  ``fold{i}/history.csv`` and ``fold{i}/confusion.png`` (where matplotlib is
  installed), and ``ckpt/fold{i}/{best,latest}``;
* ``--cv-vmapped``: ``cv_results.json`` of the same structure, every fold
  trained at once in one vmapped step
  (:mod:`~fall_multimodal_tpu_torch.train.cv_vmapped`; no per-fold files);
  ``--cv-mesh N`` cuts the folds into N groups, one per card;
* ``--grid``: ``grid_results.csv`` and ``grid_results.json``, one row per
  point in grid order with a ``rank`` column.

A fold's or a run's checkpoint directory serves through
``python -m fall_multimodal_tpu_torch.serve predict --checkpoint <out>/ckpt/fold0
--which best ...``. ``--tensorboard`` writes per-epoch scalars (tagged
``fold{i}/`` under ``--cv``, ``point{i}/`` under ``--grid``) and
``--grad-norms`` per-step gradient norms, both through
``torch.utils.tensorboard`` (the ``tensorboard`` package must be
installed); ``--profile`` writes a ``torch.profiler`` trace of the run to
``<output-dir>/profile/trace.json``.

``--mesh N`` trains the single run, ``--cv``, ``--grid`` and ``--test-only``
data-parallel over N processes, one card each
(:mod:`~fall_multimodal_tpu_torch.parallel.mesh`; the curves are one
process's at the same global batch). N > 1 needs ``torchrun
--nproc-per-node N`` and ``--distributed``, which joins the process group
before anything touches the card; only rank 0 logs and writes files.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import logging
import math
import os
import time
from typing import Dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="fall_multimodal_tpu_torch.cli",
                                description="fall_multimodal_tpu_torch trainer")
    p.add_argument("-c", "--config", required=True, help="preset name or YAML path")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. optim.lr=5e-4")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--cv", action="store_true", help="k-fold cross-validation")
    p.add_argument("--cv-vmapped", action="store_true",
                   help="k-fold CV with all folds trained at once in one vmapped step")
    p.add_argument("--cv-mesh", type=int, default=None, metavar="N",
                   help="with --cv-vmapped: cut the fold axis over N cards of this "
                        "process (N must divide the fold count)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="data-parallel training over N processes, one card each: "
                        "each step's batch split across them (applies to the "
                        "single-split, --cv, --grid and --test-only paths; for "
                        "--cv-vmapped use --cv-mesh)")
    p.add_argument("--folds", type=int, default=None,
                   help="number of CV folds (default: the config's data.n_folds)")
    p.add_argument("--grid", nargs="?", const="reference", default=None, metavar="JSON",
                   help="hyperparameter grid search (reference hyperparameter_tuning.py). "
                        "Bare --grid runs the 48-point embed_dim x n_stage x act_type "
                        "space; or pass a JSON dict of lists, e.g. "
                        '\'{"embed_dim": [16, 32]}\'. Writes grid_results.csv')
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--data-path", default=None,
                   help="dataset: a windowed pickle, or a directory of Gen-3 CSVs")
    p.add_argument("--test-only", action="store_true",
                   help="evaluate the best checkpoint (of --resume, else of "
                        "<output-dir>/ckpt) on the test split")
    p.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p.add_argument("--pretrained", default=None,
                   help="weights to start fresh training from: a checkpoint "
                        "dir (loads best), or a reference torch checkpoint "
                        "file (.pt/.pth/.npz)")
    p.add_argument("--synthetic-windows", type=int, default=2048,
                   help="synthetic dataset size when no --data-path")
    p.add_argument("--tensorboard", action="store_true",
                   help="write per-epoch scalars via torch.utils.tensorboard")
    p.add_argument("--grad-norms", action="store_true",
                   help="also write per-parameter per-step gradient norms to TensorBoard "
                        "(reference main.py:84-89; kept on the device, flushed per epoch)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the run to "
                        "<output-dir>/profile/trace.json")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed process group that torchrun "
                        "describes (MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/LOCAL_RANK; "
                        "NCCL on the card, gloo on the CPU) before anything touches "
                        "the card; --mesh N then spans its N processes")
    return p.parse_args(argv)


def load_cli_config(args):
    from fall_multimodal_tpu_torch.configs import load_config, preset_path

    path = args.config if os.path.exists(args.config) else preset_path(args.config)
    overrides = {}
    for item in args.set:
        key, _, value = item.partition("=")
        overrides[key] = value
    # the file alone first, so that a bad value in the YAML itself is not
    # reported as a --set problem
    try:
        cfg = load_config(path)
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise SystemExit(f"invalid config file {path!r}: {e}") from e
    try:
        if overrides:
            cfg = load_config(path, overrides)
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise SystemExit(f"invalid config override: {e}") from e
    if args.epochs is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=args.epochs))
    return cfg


def json_safe_history(hist):
    """history.json stays strict JSON: the NaN guard appends ``nan`` to
    train_loss, which ``json.dump`` would write as a bare ``NaN``."""
    return {k: [None if isinstance(v, float) and not math.isfinite(v) else v
                for v in series]
            for k, series in hist.items()}


def validate_args(args) -> None:
    """Conflicts among the arguments fail before any data is loaded."""
    if args.cv_mesh and not args.cv_vmapped:
        raise SystemExit(
            "--cv-mesh shards the fold axis of the vmapped CV driver; pass it together "
            "with --cv-vmapped (for data-parallel training of the other paths use --mesh N)")
    if args.mesh and args.cv_vmapped:
        raise SystemExit(
            "--mesh (batch data-parallelism) does not apply to --cv-vmapped; use "
            "--cv-mesh N to shard the fold axis")
    multi_run = args.cv or args.cv_vmapped or bool(args.grid)
    if multi_run and (args.resume or args.pretrained):
        # retraining every fold from scratch while the user thinks they
        # resumed is worse than refusing
        raise SystemExit(
            "--resume/--pretrained apply to the single-split path only; the CV and "
            "grid drivers build fresh per-fold/per-point states (per-fold checkpoints "
            "live under <output-dir>/ckpt/fold{i})")
    if multi_run and args.test_only:
        raise SystemExit(
            "--test-only applies to the single-split path only; to re-evaluate a CV "
            "fold, point --resume at its fold checkpoint dir without --cv")
    if args.epochs is not None and args.epochs < 1:
        raise SystemExit("--epochs must be >= 1")
    if args.tensorboard or args.grad_norms:
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        except ImportError as e:
            raise SystemExit(
                "--tensorboard/--grad-norms write through torch.utils.tensorboard, which "
                f"needs the 'tensorboard' package: it is not installed ({e})") from e


def main(argv=None) -> Dict:
    from fall_multimodal_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    validate_args(args)
    if args.distributed:
        from fall_multimodal_tpu_torch.parallel import initialize_distributed

        n = initialize_distributed(args.device)
        print(f"torch.distributed initialized: {n} process(es)", flush=True)
    device = resolve_device(args.device)        # no card and no --device cpu: raise now
    cfg = load_cli_config(args)
    out_dir = args.output_dir or os.path.join(
        "outputs", f"{cfg.model.name}_{time.strftime('%Y%m%dT%H%M%S')}")
    os.makedirs(out_dir, exist_ok=True)
    if args.profile:
        from fall_multimodal_tpu_torch.utils.profiling import trace

        with trace(os.path.join(out_dir, "profile")):
            return _run(args, cfg, out_dir, device)
    return _run(args, cfg, out_dir, device)


def _run(args, cfg, out_dir, device) -> Dict:
    # buffered TensorBoard events reach the disk only when the writer is closed
    holder = {}
    try:
        return _run_inner(args, cfg, out_dir, device, holder)
    finally:
        if holder.get("writer") is not None:
            holder["writer"].close()


def _scalar_callbacks(args, out_dir, holder, main_rank=True):
    """``(metrics_callback, metrics_factory, step_metrics_callback,
    step_metrics_factory)`` writing TensorBoard scalars (reference
    SummaryWriter, ``main.py:146-148``; per-step gradient norms,
    ``main.py:84-89``); the factories tag fold ``i`` ``fold{i}/`` and grid
    point ``i`` ``point{i}/``. All None without ``--tensorboard`` and
    ``--grad-norms``, and on a data mesh's ranks other than 0."""
    if not (args.tensorboard or args.grad_norms) or not main_rank:
        return None, None, None, None
    from torch.utils.tensorboard import SummaryWriter

    writer = holder["writer"] = SummaryWriter(log_dir=out_dir)
    tag_prefix = "point" if args.grid else "fold"

    def write(prefix):
        def cb(step, scalars):
            for name, value in scalars.items():
                writer.add_scalar(prefix + name, value, step)
        return cb

    def tagged(i):
        return write(f"{tag_prefix}{i}/")

    if args.grad_norms:
        return write(""), tagged, write(""), tagged
    return write(""), tagged, None, None


def _run_inner(args, cfg, out_dir, device, holder) -> Dict:
    from fall_multimodal_tpu_torch.data import load_dataset, split_dataset, to_device
    from fall_multimodal_tpu_torch.models import build_model
    from fall_multimodal_tpu_torch.train import (
        build_optimizer,
        classification_report,
        create_train_state,
        evaluate,
        make_eval_epoch,
        param_count,
    )
    from fall_multimodal_tpu_torch.train.cv import (
        cross_validate,
        grid_search,
        reference_grid,
        run_fold,
    )
    from fall_multimodal_tpu_torch.utils import create_logger
    from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer
    from fall_multimodal_tpu_torch.utils.profiling import model_summary

    mesh = None
    if args.mesh:
        from fall_multimodal_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.mesh, device=device)
    main_rank = mesh is None or mesh.rank == 0
    # ranks other than 0 write no file and log only warnings and errors
    logger = create_logger(output_dir=out_dir if main_rank else None,
                           name="fall_multimodal_tpu_torch.cli",
                           level=logging.INFO if main_rank else logging.WARNING)
    logger.info(f"config: {cfg.model.name} dataset={cfg.data.dataset} device={device}")
    data = load_dataset(
        cfg.data.dataset,
        path=args.data_path or cfg.data.path,
        seq_len=cfg.data.seq_len,
        num_joints=cfg.data.num_joints,
        num_classes=cfg.data.num_classes,
        sensor_dim=cfg.data.sensor_dim,
        seed=cfg.seed,
        n_windows=args.synthetic_windows,
    )
    logger.info(f"dataset: {len(data)} windows, {data.num_classes} classes")
    if mesh is not None:
        logger.info(f"data-parallel mesh: {mesh.size} process(es), rank {mesh.rank} on "
                    f"{mesh.device}")
    if main_rank:
        with open(os.path.join(out_dir, "config.json"), "w") as fh:
            json.dump(cfg.to_dict(), fh, indent=2, default=str)
    # the parameter table at the start of a run (the reference runs
    # torchinfo.summary before training, Multimodal_Fall3/main.py:326-328)
    logger.info("model summary:\n" + model_summary(build_model(cfg)))
    metrics_callback, metrics_factory, step_metrics_callback, step_metrics_factory = \
        _scalar_callbacks(args, out_dir, holder, main_rank)

    if args.grid:
        grid = reference_grid() if args.grid == "reference" else json.loads(args.grid)
        if not isinstance(grid, dict) or not all(isinstance(v, (list, tuple))
                                                 for v in grid.values()):
            raise SystemExit("--grid expects a JSON dict of lists, "
                             'e.g. \'{"embed_dim": [16, 32]}\'')
        empty = [k for k, v in grid.items() if not list(v)]
        if not grid or empty:
            raise SystemExit("--grid needs a non-empty dict of non-empty lists"
                             + (f"; empty values for {', '.join(empty)}" if empty else ""))
        rows = grid_search(cfg, data, grid, epochs=args.epochs, logger=logger,
                           grad_norms=args.grad_norms, metrics_factory=metrics_factory,
                           step_metrics_factory=step_metrics_factory, device=device,
                           mesh=mesh)
        if not main_rank:
            return {"grid": rows}
        # one row per point in grid order (the reference's accumulation order,
        # hyperparameter_tuning.py:466-471), ranked in a column
        with open(os.path.join(out_dir, "grid_results.csv"), "w", newline="") as fh:
            csv_writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
            csv_writer.writeheader()
            csv_writer.writerows(rows)
        with open(os.path.join(out_dir, "grid_results.json"), "w") as fh:
            json.dump(rows, fh, indent=2)
        logger.info(f"best grid point: {min(rows, key=lambda r: r['rank'])}")
        return {"grid": rows}

    if args.cv or args.cv_vmapped:
        if args.cv_vmapped:
            from fall_multimodal_tpu_torch.parallel import make_mesh
            from fall_multimodal_tpu_torch.train.cv_vmapped import cross_validate_vmapped

            fold_mesh = (make_mesh(args.cv_mesh, axis="fold", device=device)
                         if args.cv_mesh else None)
            results = cross_validate_vmapped(
                cfg, data, n_folds=args.folds, epochs=args.epochs, logger=logger,
                mesh=fold_mesh, grad_norms=args.grad_norms, metrics_factory=metrics_factory,
                step_metrics_factory=step_metrics_factory, scan_epochs=cfg.train.scan_epochs,
                device=device)
        else:
            results = cross_validate(
                cfg, data, n_folds=args.folds, epochs=args.epochs, logger=logger,
                checkpoint_dir=os.path.join(out_dir, "ckpt"), artifacts_dir=out_dir,
                grad_norms=args.grad_norms, metrics_factory=metrics_factory,
                step_metrics_factory=step_metrics_factory, device=device, mesh=mesh)
        if not main_rank:
            return results
        with open(os.path.join(out_dir, "cv_results.json"), "w") as fh:
            json.dump(results, fh, indent=2)
        logger.info(f"CV summary: {results['summary']}")
        return results

    splits_np = split_dataset(data, split=cfg.data.split, seed=cfg.seed,
                              by_video=cfg.data.split_by_video)
    splits = {k: to_device(v, device) for k, v in splits_np.items()}
    ckpt = (Checkpointer(os.path.join(out_dir, "ckpt"))
            if cfg.save_checkpoint and main_rank else None)

    if args.test_only:
        state = create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed, device=device)
        src = Checkpointer(args.resume or os.path.join(out_dir, "ckpt"))
        state, epoch, best = src.restore("best", state)
        logger.info(f"restored best (epoch {epoch}, val acc {best:.5f}) from {src.directory}")
        if mesh is not None:
            from fall_multimodal_tpu_torch.parallel import replicate_state

            state = replicate_state(state, mesh)
        eval_epoch = make_eval_epoch(data.num_classes,
                                     label_smoothing=cfg.train.label_smoothing,
                                     softmax_before_ce=cfg.model.softmax_output, mesh=mesh)
        test = evaluate(eval_epoch, state, splits["test"], cfg.train.batch_size)
        report = classification_report(test.confusion)
        logger.info(f"test accuracy {test.accuracy:.5f}\n{report}")
        if main_rank:
            with open(os.path.join(out_dir, "report.txt"), "w") as fh:
                fh.write(report)
        return {"test_accuracy": test.accuracy}

    result = run_fold(cfg, splits, epochs=args.epochs, logger=logger, checkpointer=ckpt,
                      metrics_callback=metrics_callback,
                      resume_from=args.resume or cfg.resume_from,
                      pretrained_path=args.pretrained or cfg.pretrained_weight_path,
                      grad_norms=args.grad_norms,
                      step_metrics_callback=step_metrics_callback,
                      device=device, mesh=mesh)
    result_row = {"best_val_accuracy": result.best_val_accuracy,
                  "test_accuracy": result.test.accuracy}
    if not main_rank:
        return result_row
    logger.info(f"{param_count(result.state):,} trainable parameters")
    logger.info(f"best val accuracy {result.best_val_accuracy:.5f}; "
                f"test accuracy {result.test.accuracy:.5f}")
    report = classification_report(result.test.confusion)
    logger.info("\n" + report)
    with open(os.path.join(out_dir, "history.json"), "w") as fh:
        json.dump(json_safe_history(result.history), fh, indent=2)
    with open(os.path.join(out_dir, "report.txt"), "w") as fh:
        fh.write(report)
    return result_row


if __name__ == "__main__":
    main()
