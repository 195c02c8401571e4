"""Convert a checkpoint of the JAX package's trainer into the PyTorch port's:
weights to serve and fine-tune from, or a whole train state to resume.

    # weights only: an .npz of the port's state_dict
    python experiments/convert_jax_checkpoint.py --config gstcan_urfall_3stream \
        --checkpoint outputs/run/ckpt [--which best] --output weights.npz
    # the whole run: a port checkpoint directory (best/, latest/)
    python experiments/convert_jax_checkpoint.py --config outputs/run/config.json \
        --checkpoint outputs/run/ckpt --output outputs/run_torch/ckpt
    python -m fall_multimodal_tpu_torch.cli --config outputs/run/config.json \
        --resume outputs/run_torch/ckpt --output-dir outputs/run_torch

Runs where JAX and orbax are installed (the port imports neither): each
checkpoint is restored through the JAX package's
``utils/checkpoint.py:Checkpointer`` against a template train state of
``--config``'s model, and carried across with numpy in and numpy out.

What is converted. The weights and BatchNorm statistics
(``fall_multimodal_tpu_torch.interop.state_dict_from_jax_variables``). With
a directory ``--output``, also the optimizer's state
(``interop.optimizer_state_from_jax``): RMSprop's square averages, Adam's
moments and count, SGD's momentum buffers, the gradient-accumulation state
(``mini_step``, ``gradient_step``, the accumulators), each leaf through its
parameter's layout transform; and the step, epoch and best accuracy. Each
of ``best`` and ``latest`` that the JAX directory holds becomes
``<output>/<name>/checkpoint.pt``, which ``run_fold(resume_from=...)`` and
the CLI's ``--resume`` continue and ``Predictor.from_checkpoint`` serves.

What is refused. An optax state the JAX package's ``build_optimizer`` does
not make, or one that disagrees with the config's optimizer, raises with the
leaf named; nothing is dropped silently.

The generator starts fresh. The JAX train state's ``jax.random`` key has no
``torch.Generator`` counterpart, so a converted checkpoint stores the
config's ``seed`` and the port seeds its generator with it. The port's
``fit`` reseeds at every epoch from the shuffle seed and the epoch, so the
epochs after a resume draw as they would in a port run; only their draws
differ from the JAX run's, as every draw of the two packages does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_template(config_path: str):
    """A JAX train state of the config's model to restore into (orbax needs
    its structure, dtypes and shapes)."""
    import jax.numpy as jnp

    from fall_multimodal_tpu.configs import load_config as jax_load_config
    from fall_multimodal_tpu.models import build_model
    from fall_multimodal_tpu.train.optim import build_optimizer
    from fall_multimodal_tpu.train.state import create_train_state

    jax_cfg = jax_load_config(config_path)
    d = jax_cfg.data
    return create_train_state(
        build_model(jax_cfg), build_optimizer(jax_cfg),
        jnp.zeros((2, d.seq_len, d.num_joints, d.in_channels), jnp.float32),
        jnp.zeros((2, d.seq_len, d.sensor_dim), jnp.float32), seed=jax_cfg.seed)


def restore(config_path: str, checkpoint_dir: str, which: str = "best", template=None):
    """``(state, epoch, best_acc)`` of the ``which`` checkpoint in a JAX
    ``Checkpointer`` directory, for the model of the config at
    ``config_path`` (a preset YAML, or a run's ``config.json``), with numpy
    leaves (the ``jax.random`` key left out)."""
    import jax

    from fall_multimodal_tpu.utils.checkpoint import Checkpointer

    template = template if template is not None else jax_template(config_path)
    state, epoch, best_acc = Checkpointer(checkpoint_dir).restore(which, template)
    return jax.tree.map(np.asarray, state._replace(rng=None)), epoch, best_acc


def convert(config_path: str, checkpoint_dir: str, which: str = "best"):
    """The port's state_dict (numpy arrays) of the ``which`` checkpoint."""
    from fall_multimodal_tpu_torch.configs import load_config
    from fall_multimodal_tpu_torch.interop import state_dict_from_jax_variables

    state, _, _ = restore(config_path, checkpoint_dir, which)
    return state_dict_from_jax_variables(
        load_config(config_path), {"params": state.params, "batch_stats": state.batch_stats})


def convert_state(config_path: str, checkpoint_dir: str, which: str, template=None) -> dict:
    """The payload of the port's ``Checkpointer`` (``checkpoint.pt``) for the
    ``which`` checkpoint: model, optimizer, step, epoch, best accuracy and
    the config's seed for the generator."""
    import torch

    from fall_multimodal_tpu_torch.configs import load_config
    from fall_multimodal_tpu_torch.interop import (
        optimizer_state_from_jax,
        state_dict_from_jax_variables,
    )

    cfg = load_config(config_path)
    state, epoch, best_acc = restore(config_path, checkpoint_dir, which, template)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    model = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in state_dict_from_jax_variables(cfg, variables).items()}
    optimizer = optimizer_state_from_jax(cfg, state.opt_state, state.params, state.batch_stats,
                                         int(state.step))
    return {"model": model, "optimizer": optimizer, "step": int(state.step),
            "generator": int(cfg.seed), "epoch": int(epoch), "best_acc": float(best_acc)}


def write_checkpoint_dir(config_path: str, checkpoint_dir: str, output: str) -> list:
    """Every checkpoint (``best``, ``latest``) of the JAX directory as
    ``<output>/<name>/checkpoint.pt``; returns the names written."""
    import torch

    from fall_multimodal_tpu.utils.checkpoint import Checkpointer
    from fall_multimodal_tpu_torch.utils.checkpoint import FILE

    source = Checkpointer(checkpoint_dir)
    template = jax_template(config_path)
    written = []
    for name in ("best", "latest"):
        if not source.has(name):
            continue
        os.makedirs(os.path.join(output, name), exist_ok=True)
        torch.save(convert_state(config_path, checkpoint_dir, name, template),
                   os.path.join(output, name, FILE))
        written.append(name)
    if not written:
        raise SystemExit(f"{checkpoint_dir} holds neither a best nor a latest checkpoint")
    return written


def main(argv=None) -> str:
    from fall_multimodal_tpu_torch.configs import preset_path

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True,
                   help="preset name, YAML path, or a run's config.json")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir of the JAX trainer (<out>/ckpt or <out>/ckpt/fold{i})")
    p.add_argument("--which", default="best", choices=["best", "latest"],
                   help="the checkpoint an .npz output takes")
    p.add_argument("--output", required=True,
                   help="an .npz (weights only) or a directory (the port's checkpoints)")
    args = p.parse_args(argv)
    config_path = args.config if os.path.exists(args.config) else preset_path(args.config)
    if args.output.endswith(".npz"):
        sd = convert(config_path, args.checkpoint, args.which)
        np.savez(args.output, **sd)
        print(f"wrote {args.output}: {len(sd)} arrays of the port's state_dict")
    else:
        names = write_checkpoint_dir(config_path, args.checkpoint, args.output)
        print(f"wrote {args.output}: {', '.join(names)} (weights, optimizer state, step, "
              "epoch, best accuracy)")
    return args.output


if __name__ == "__main__":
    main()
