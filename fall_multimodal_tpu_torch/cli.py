"""Command-line trainer of the port: the single-run path of the JAX
package's ``cli.py`` (``_run_inner``, ``cli.py:239-256,371-428``).

    python -m fall_multimodal_tpu_torch.cli --config gstcan_urfall_3stream \\
        --set optim.lr=5e-4 --set train.epochs=50 --output-dir outputs/run1
    python -m fall_multimodal_tpu_torch.cli --config gstcan_urfall_3stream \\
        --device cpu --set train.epochs=1 --set train.batch_size=8 \\
        --synthetic-windows 64

Trains on the card (``--device cuda``, the default) unless ``--device cpu``
is passed, and writes under the output dir ``config.json``, ``log.txt``,
``history.json`` (per-epoch curves), ``report.txt`` (classification report
of the test split on the best state) and ``ckpt/{best,latest}/checkpoint.pt``
(:mod:`fall_multimodal_tpu_torch.utils.checkpoint`; ``best`` serves through
``python -m fall_multimodal_tpu_torch.serve ... --checkpoint
<out>/ckpt/best/checkpoint.pt``). The output dir is never wiped, so
``--resume <out>/ckpt`` continues a run at its saved epoch and
``--test-only`` evaluates ``best``.

The JAX CLI's ``--cv``, ``--cv-vmapped``, ``--grid``, ``--mesh``,
``--tensorboard``, ``--grad-norms``, ``--profile`` and ``--distributed`` are
not offered yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--data-path", default=None, help="windowed dataset pickle")
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
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
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


def main(argv=None) -> Dict:
    from fall_multimodal_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    if args.epochs is not None and args.epochs < 1:
        raise SystemExit("--epochs must be >= 1")
    device = resolve_device(args.device)        # no card and no --device cpu: raise now
    cfg = load_cli_config(args)
    out_dir = args.output_dir or os.path.join(
        "outputs", f"{cfg.model.name}_{time.strftime('%Y%m%dT%H%M%S')}")
    os.makedirs(out_dir, exist_ok=True)
    return _run(args, cfg, out_dir, device)


def _run(args, cfg, out_dir, device) -> Dict:
    from fall_multimodal_tpu_torch.data import load_dataset, split_dataset, to_device
    from fall_multimodal_tpu_torch.train import (
        build_optimizer,
        classification_report,
        create_train_state,
        evaluate,
        make_eval_epoch,
        param_count,
    )
    from fall_multimodal_tpu_torch.train.cv import run_fold
    from fall_multimodal_tpu_torch.utils import create_logger
    from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

    logger = create_logger(output_dir=out_dir, name="fall_multimodal_tpu_torch.cli")
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
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(cfg.to_dict(), fh, indent=2, default=str)

    splits_np = split_dataset(data, split=cfg.data.split, seed=cfg.seed,
                              by_video=cfg.data.split_by_video)
    splits = {k: to_device(v, device) for k, v in splits_np.items()}
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt")) if cfg.save_checkpoint else None

    if args.test_only:
        state = create_train_state(cfg, build_optimizer(cfg), seed=cfg.seed, device=device)
        src = Checkpointer(args.resume or os.path.join(out_dir, "ckpt"))
        state, epoch, best = src.restore("best", state)
        logger.info(f"restored best (epoch {epoch}, val acc {best:.5f}) from {src.directory}")
        eval_epoch = make_eval_epoch(data.num_classes,
                                     label_smoothing=cfg.train.label_smoothing,
                                     softmax_before_ce=cfg.model.softmax_output)
        test = evaluate(eval_epoch, state, splits["test"], cfg.train.batch_size)
        report = classification_report(test.confusion)
        logger.info(f"test accuracy {test.accuracy:.5f}\n{report}")
        with open(os.path.join(out_dir, "report.txt"), "w") as fh:
            fh.write(report)
        return {"test_accuracy": test.accuracy}

    result = run_fold(cfg, splits, epochs=args.epochs, logger=logger, checkpointer=ckpt,
                      resume_from=args.resume or cfg.resume_from,
                      pretrained_path=args.pretrained or cfg.pretrained_weight_path,
                      device=device)
    logger.info(f"{param_count(result.state):,} trainable parameters")
    logger.info(f"best val accuracy {result.best_val_accuracy:.5f}; "
                f"test accuracy {result.test.accuracy:.5f}")
    report = classification_report(result.test.confusion)
    logger.info("\n" + report)
    with open(os.path.join(out_dir, "history.json"), "w") as fh:
        json.dump(json_safe_history(result.history), fh, indent=2)
    with open(os.path.join(out_dir, "report.txt"), "w") as fh:
        fh.write(report)
    return {"best_val_accuracy": result.best_val_accuracy,
            "test_accuracy": result.test.accuracy}


if __name__ == "__main__":
    main()
