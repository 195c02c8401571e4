"""Convert a checkpoint of the JAX package's trainer into weights the
PyTorch port serves and fine-tunes from.

    python experiments/convert_jax_checkpoint.py --config gstcan_urfall_3stream \
        --checkpoint outputs/run/ckpt [--which best] --output weights.npz

Runs where JAX and orbax are installed (the port imports neither). It
restores ``<checkpoint>/<which>`` through the JAX package's
``utils/checkpoint.py:Checkpointer`` against a template train state of
``--config``'s model, takes its ``params`` and ``batch_stats``, carries them
to the port's state_dict names with
``fall_multimodal_tpu_torch.interop.state_dict_from_jax_variables`` (numpy
in, numpy out) and writes them as an ``.npz`` of named arrays, which
``fall_multimodal_tpu_torch.serve.Predictor.from_torch_checkpoint``, the
serving CLI's ``--checkpoint`` and ``run_fold(pretrained_path=...)`` read.
Only the weights are converted: the optimizer state (optax) is not, so a
converted checkpoint starts a new run rather than resuming one.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(config_path: str, checkpoint_dir: str, which: str = "best"):
    """The port's state_dict (numpy arrays) of the ``which`` checkpoint in a
    JAX ``Checkpointer`` directory, for the model of the config at
    ``config_path`` (a preset YAML, or a run's ``config.json``)."""
    import jax
    import jax.numpy as jnp

    from fall_multimodal_tpu.configs import load_config as jax_load_config
    from fall_multimodal_tpu.models import build_model
    from fall_multimodal_tpu.train.optim import build_optimizer
    from fall_multimodal_tpu.train.state import create_train_state
    from fall_multimodal_tpu.utils.checkpoint import Checkpointer
    from fall_multimodal_tpu_torch.configs import load_config
    from fall_multimodal_tpu_torch.interop import state_dict_from_jax_variables

    jax_cfg = jax_load_config(config_path)
    d = jax_cfg.data
    template = create_train_state(
        build_model(jax_cfg), build_optimizer(jax_cfg),
        jnp.zeros((2, d.seq_len, d.num_joints, d.in_channels), jnp.float32),
        jnp.zeros((2, d.seq_len, d.sensor_dim), jnp.float32), seed=jax_cfg.seed)
    state, _, _ = Checkpointer(checkpoint_dir).restore(which, template)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return state_dict_from_jax_variables(load_config(config_path), variables)


def main(argv=None) -> str:
    from fall_multimodal_tpu_torch.configs import preset_path

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True,
                   help="preset name, YAML path, or a run's config.json")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir of the JAX trainer (<out>/ckpt or <out>/ckpt/fold{i})")
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--output", required=True, help="the .npz to write")
    args = p.parse_args(argv)
    if not args.output.endswith(".npz"):
        raise SystemExit("--output must name an .npz file")
    config_path = args.config if os.path.exists(args.config) else preset_path(args.config)
    sd = convert(config_path, args.checkpoint, args.which)
    np.savez(args.output, **sd)
    print(f"wrote {args.output}: {len(sd)} arrays of the port's state_dict")
    return args.output


if __name__ == "__main__":
    main()
