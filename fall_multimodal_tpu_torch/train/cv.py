"""One training run of one split, k-fold cross-validation and the
hyperparameter grid (counterpart of the JAX package's ``train/cv.py``).

Capabilities of ``main_cross_validation.py:256-370`` (10-fold CV with
per-fold macro PRF collected into a summary) and
``hyperparameter_tuning.py:442-471`` (cartesian grid over model kwargs,
one training run per point, accumulated into a CSV). Each fold keeps its
own checkpoint directory (the reference shared one ``best_model.pt``
across folds). Folds and grid points run one after another, each on one
device or data-parallel over a mesh (``mesh=``); the fold-parallel driver
is :mod:`~fall_multimodal_tpu_torch.train.cv_vmapped`.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.data.augment import make_augment_fn
from fall_multimodal_tpu_torch.data.loaders import kfold_datasets, split_dataset
from fall_multimodal_tpu_torch.data.pipeline import DeviceData, to_device
from fall_multimodal_tpu_torch.data.synthetic import WindowedDataset
from fall_multimodal_tpu_torch.train.loop import FitResult, fit
from fall_multimodal_tpu_torch.train.optim import build_optimizer, build_schedule
from fall_multimodal_tpu_torch.train.state import create_train_state
from fall_multimodal_tpu_torch.utils.device import resolve_device


def run_fold(
    config: Config,
    splits: Dict[str, DeviceData],
    epochs: Optional[int] = None,
    logger=None,
    checkpointer=None,
    fold_seed: int = 0,
    metrics_callback=None,
    resume_from: Optional[str] = None,
    pretrained_path: Optional[str] = None,
    grad_norms: bool = False,
    step_metrics_callback=None,
    device="cuda",
    mesh=None,
) -> FitResult:
    """Train one split on ``device`` (the card unless the caller passes
    ``"cpu"``; the splits must already be there, :func:`~fall_multimodal_tpu_torch.
    data.pipeline.to_device`) and return the :class:`FitResult`.

    ``resume_from``: a checkpoint directory; restores the full latest state
    (model, optimizer, step) and continues at the saved epoch, with the
    saved best state kept for the final test (reference RESUME_FROM,
    ``main.py:295-304``). ``pretrained_path``: weights to start from, then
    train from epoch 1 (reference PRETRAINED_WEIGHT_PATH,
    ``main.py:306-310``): a reference checkpoint file (``.pt``/``.pth``/
    ``.npz``, read by :func:`~fall_multimodal_tpu_torch.interop.
    load_state_dict_file`), or a checkpoint directory (its ``best`` model).
    ``train.dtype: bfloat16`` trains under ``torch.autocast``. ``mesh``: a
    data mesh (:func:`~fall_multimodal_tpu_torch.parallel.mesh.make_mesh`)
    trains data-parallel, each rank on ``device`` (its own card).
    """
    dev = torch.empty(0, device=resolve_device(device)).device   # with its index
    on = {split.features.device for split in splits.values()}
    if on != {dev}:
        raise ValueError(f"run_fold(device={str(dev)!r}) got splits on {sorted(map(str, on))}; "
                         "put them there with to_device(data, device)")
    steps_per_epoch = max(1, splits["train"].n // config.train.batch_size)
    optimizer = build_optimizer(
        config.optim,
        scheduler=config.lr_scheduler,
        steps_per_epoch=steps_per_epoch,
        max_norm=config.train.max_norm,
        accum_iter=config.train.accum_iter,
    )
    state = create_train_state(config, optimizer, seed=config.seed + fold_seed,
                               weight_init=config.model.weight_init, device=dev)
    start_epoch, initial_best, initial_best_state = 1, -1.0, None
    if resume_from:
        from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

        src = Checkpointer(resume_from)
        if src.has("best"):
            # the final test must run on the best weights even if no epoch
            # after the resume improves (the reference reloads best,
            # main.py:344); the latest weights are not the best ones
            initial_best_state, _, _ = src.restore("best", state.snapshot())
        state, saved_epoch, initial_best = src.restore("latest", state)
        start_epoch = saved_epoch + 1
        if logger:
            logger.info(f"resumed from {resume_from} at epoch {saved_epoch} "
                        f"(best acc {initial_best:.4f})")
    elif pretrained_path:
        if pretrained_path.endswith((".pt", ".pth", ".npz")):
            from fall_multimodal_tpu_torch.interop import load_into, load_state_dict_file

            # reference checkpoint (or a port checkpoint file): fine-tune
            # from its weights
            load_into(state.model, load_state_dict_file(pretrained_path))
            if logger:
                logger.info(f"loaded torch weights from {pretrained_path}")
        else:
            from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

            best = torch.load(Checkpointer(pretrained_path).file("best"),
                              map_location=state.device, weights_only=True)
            state.model.load_state_dict(best["model"])
            if logger:
                logger.info(f"loaded pretrained weights from {pretrained_path}")

    compute_dtype = torch.bfloat16 if config.train.dtype == "bfloat16" else None
    lr_fn = build_schedule(config.lr_scheduler, config.optim.lr, steps_per_epoch)
    return fit(
        state,
        splits,
        epochs=epochs or config.train.epochs,
        batch_size=config.train.batch_size,
        num_classes=splits["train"].labels.shape[-1],
        label_smoothing=config.train.label_smoothing,
        softmax_before_ce=config.model.softmax_output,
        drop_last=config.train.drop_last,
        shuffle_seed=config.seed + fold_seed,
        logger=logger,
        log_every=config.logging_interval,
        checkpointer=checkpointer,
        compute_dtype=compute_dtype,
        metrics_callback=metrics_callback,
        start_epoch=start_epoch,
        initial_best_acc=initial_best,
        initial_best_state=initial_best_state,
        grad_norms=grad_norms,
        step_metrics_callback=step_metrics_callback,
        lr_fn=lr_fn if callable(lr_fn) else None,
        epoch_impl=config.train.epoch_impl,
        scan_epochs=config.train.scan_epochs,
        augment_fn=make_augment_fn(config.augment, config.graph.layout),
        mesh=mesh,
    )


def cross_validate(
    config: Config,
    data: WindowedDataset,
    n_folds: Optional[int] = None,
    epochs: Optional[int] = None,
    logger=None,
    checkpoint_dir: Optional[str] = None,
    artifacts_dir: Optional[str] = None,
    grad_norms: bool = False,
    metrics_factory=None,
    step_metrics_factory=None,
    device="cuda",
    mesh=None,
) -> Dict[str, Any]:
    """K-fold CV over unique videos (``config.data.split_by_video``; sample
    stratified folds with ``config.data.stratify_folds``), each fold trained
    by :func:`run_fold` with ``fold_seed=i`` on ``device``. Returns
    ``{"folds": [per-fold rows], "summary": {"<metric>_mean", "<metric>_std"}}``.

    ``checkpoint_dir``: fold ``i`` checkpoints under ``<dir>/fold{i}``
    (``best``, ``latest``). ``artifacts_dir``: fold ``i`` leaves the notebook
    CV loop's artifacts under ``fold{i}/`` (:func:`_write_fold_artifacts`).
    ``metrics_factory(i)`` / ``step_metrics_factory(i)`` return fold ``i``'s
    ``(epoch, scalars)`` / ``(step, scalars)`` callbacks. ``mesh``: each
    fold data-parallel (:func:`run_fold`); only rank 0 logs and writes.
    """
    from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

    if mesh is not None and mesh.rank != 0:
        logger = checkpoint_dir = artifacts_dir = None

    n_folds = n_folds or config.data.n_folds
    folds = kfold_datasets(data, n_folds=n_folds, seed=config.seed,
                           by_video=config.data.split_by_video,
                           stratify=config.data.stratify_folds)
    per_fold: List[Dict[str, float]] = []
    for i, fold in enumerate(folds):
        splits = {k: to_device(v, device) for k, v in fold.items()}
        ckpt = None if checkpoint_dir is None else Checkpointer(f"{checkpoint_dir}/fold{i}")
        result = run_fold(
            config, splits, epochs=epochs, logger=logger, checkpointer=ckpt, fold_seed=i,
            grad_norms=grad_norms,
            metrics_callback=metrics_factory(i) if metrics_factory else None,
            step_metrics_callback=step_metrics_factory(i) if step_metrics_factory else None,
            device=device, mesh=mesh)
        if artifacts_dir is not None:
            _write_fold_artifacts(artifacts_dir, i, result, logger=logger)
        row = fold_row(i, result.best_val_accuracy, result.test.stats)
        per_fold.append(row)
        if logger:
            logger.info(f"fold {i}: test acc {row['test_accuracy']:.4f} "
                        f"macro F1 {row['macro_f1']:.4f}")
    return cv_results(per_fold)


def fold_row(fold: int, val_accuracy: float, stats: Mapping[str, Any]) -> Dict[str, float]:
    """One fold's row of ``cv_results.json`` from its best validation accuracy
    and the test statistics of its best state (``prf_from_confusion``)."""
    return {
        "fold": fold,
        "val_accuracy": float(val_accuracy),
        "test_accuracy": float(stats["accuracy"]),
        "macro_precision": float(stats["macro_precision"]),
        "macro_recall": float(stats["macro_recall"]),
        "macro_f1": float(stats["macro_f1"]),
        "micro_f1": float(stats["micro_f1"]),
    }


def cv_results(per_fold: List[Dict[str, float]]) -> Dict[str, Any]:
    """``{"folds": rows, "summary": {"<metric>_mean", "<metric>_std"}}``."""
    metrics = [k for k in per_fold[0] if k != "fold"]
    summary = {f"{m}_{agg}": float(getattr(np, agg)([row[m] for row in per_fold]))
               for m in metrics for agg in ("mean", "std")}
    return {"folds": per_fold, "summary": summary}


def _write_fold_artifacts(artifacts_dir: str, fold_i: int, result: FitResult,
                          logger=None) -> None:
    """Fold ``fold_i``'s notebook artifacts (``GSTCAN_HAR_conv_10kfold.ipynb:7``)
    under ``<artifacts_dir>/fold{i}/``: ``history.csv`` (the per-epoch curves)
    and ``confusion.png`` (the test confusion heatmap; skipped with a warning
    where matplotlib is not installed)."""
    fold_dir = os.path.join(artifacts_dir, f"fold{fold_i}")
    os.makedirs(fold_dir, exist_ok=True)
    hist = result.history
    # after fit's NaN guard breaks an epoch, train_loss is one entry longer
    # than the other series: keep every column and leave the short ones blank
    epochs_run = max((len(v) for v in hist.values()), default=0)
    with open(os.path.join(fold_dir, "history.csv"), "w", newline="") as fh:
        writer = csv.writer(fh)
        cols = list(hist)
        writer.writerow(["epoch"] + cols)
        for e in range(epochs_run):
            writer.writerow([e + 1] + [hist[c][e] if e < len(hist[c]) else "" for c in cols])
    if result.test is not None:
        from fall_multimodal_tpu_torch.train.metrics import save_confusion_png

        try:
            save_confusion_png(result.test.confusion, os.path.join(fold_dir, "confusion.png"),
                               title=f"Fold {fold_i} confusion")
        except ImportError:
            if logger:
                logger.warning(f"matplotlib unavailable; skipping confusion.png for "
                               f"fold {fold_i}")


def grid_search(
    config: Config,
    data: WindowedDataset,
    grid: Mapping[str, Iterable[Any]],
    epochs: Optional[int] = None,
    logger=None,
    grad_norms: bool = False,
    metrics_factory=None,
    step_metrics_factory=None,
    device="cuda",
    mesh=None,
) -> List[Dict[str, Any]]:
    """Cartesian grid over model kwargs (e.g. embed_dim x n_stage x
    act_type, ``hyperparameter_tuning.py:450-458``). Each point trains on
    the config's split and records val/test accuracy; the rows come in grid
    iteration order (the reference CSV's order,
    ``hyperparameter_tuning.py:461-471``) with a ``rank`` column by
    validation accuracy. ``metrics_factory(i)`` / ``step_metrics_factory(i)``
    return point ``i``'s callbacks; ``mesh``: each point data-parallel."""
    if mesh is not None and mesh.rank != 0:
        logger = None
    keys = list(grid)
    rows: List[Dict[str, Any]] = []
    for point_i, values in enumerate(itertools.product(*(grid[k] for k in keys))):
        point = dict(zip(keys, values))
        cfg = config.replace(model=dataclasses.replace(
            config.model, kwargs={**config.model.kwargs, **point}))
        splits = {k: to_device(v, device) for k, v in split_dataset(
            data, split=config.data.split, seed=cfg.seed,
            by_video=config.data.split_by_video).items()}
        result = run_fold(
            cfg, splits, epochs=epochs, logger=logger, grad_norms=grad_norms,
            metrics_callback=metrics_factory(point_i) if metrics_factory else None,
            step_metrics_callback=(step_metrics_factory(point_i) if step_metrics_factory
                                   else None),
            device=device, mesh=mesh)
        row = {**point, "val_accuracy": result.best_val_accuracy,
               "test_accuracy": (float(result.test.stats["accuracy"]) if result.test
                                 else None)}
        rows.append(row)
        if logger:
            logger.info(f"grid point {point}: val {row['val_accuracy']:.4f}")
    # the rows keep grid order (the reference artifact's); the ranking is a column
    order = sorted(range(len(rows)), key=lambda i: -(rows[i]["val_accuracy"] or 0))
    for rank, i in enumerate(order):
        rows[i]["rank"] = rank + 1
    return rows


def reference_grid() -> Dict[str, List[Any]]:
    """The reference's 48-point search space (``hyperparameter_tuning.py:449-454``)."""
    return {
        "embed_dim": [16, 32, 64],
        "n_stage": [1, 2, 3, 4],
        "act_type": ["relu", "leakyrelu", "tanh", "gelu"],
    }
