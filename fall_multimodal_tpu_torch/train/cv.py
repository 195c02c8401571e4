"""One training run of one split (counterpart of the JAX package's
``train/cv.py:31-149``, ``run_fold``).

The k-fold and grid drivers of the JAX package (``cross_validate``,
``grid_search``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fall_multimodal_tpu_torch.configs import Config
from fall_multimodal_tpu_torch.data.augment import make_augment_fn
from fall_multimodal_tpu_torch.data.pipeline import DeviceData
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
    ``train.dtype: bfloat16`` trains under ``torch.autocast``.
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
    )
