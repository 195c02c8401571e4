"""Training-time augmentation for skeleton + sensor windows, on the device
(counterpart of the JAX package's ``data/augment.py:55-163``).

Every transform is drawn per window per step inside the train step from the
run's seeded ``torch.Generator`` (on the same device as the batch), so an
epoch's augmentation needs no host work. The motion stream is derived
in-model from the augmented points, so both skeleton streams stay
geometrically consistent.

Geometry notes:

* Windows are ``scale_pose``-normalized per window to [-1, 1] per axis
  (``har_create4.py:40-51``), so transforms operate in that space:
  rotation/scale act about the window's (x, y) centroid, translation is in
  normalized units, and a horizontal mirror is ``x -> -x`` plus a
  left/right joint swap.
* The confidence/score channel (C > 2) is never touched.
* Flipping needs the layout's left/right pairing (:data:`FLIP_PERMUTATIONS`,
  the JAX package's table, copied). Asking for ``flip_prob > 0`` on a layout
  without one raises at build time, not mid-train.

The draws cannot equal the JAX package's (``jax.random`` and
``torch.Generator`` are different streams); the transforms and their ranges
are the same.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fall_multimodal_tpu_torch.configs.config import AugmentConfig

__all__ = ["FLIP_PERMUTATIONS", "make_augment_fn"]

# Left/right joint swap per skeleton layout; each is an involution that maps
# the layout's bone set onto itself and fixes the center joint (see the JAX
# package's ``data/augment.py`` for the joint orders).
FLIP_PERMUTATIONS = {
    "coco_cut": np.array([0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 13]),
    "coco_mmpose": np.array(
        [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 17]
    ),
    "openpose": np.array(
        [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16]
    ),
    "ntu-rgb+d": np.array(
        [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 16, 17, 18, 19,
         12, 13, 14, 15, 20, 23, 24, 21, 22]
    ),
    "ntu_edge": np.array(
        [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 16, 17, 18, 19,
         12, 13, 14, 15, 22, 23, 20, 21]
    ),
}

AugmentFn = Callable[[torch.Generator, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]


def make_augment_fn(cfg: AugmentConfig, layout: str = "coco_cut") -> Optional[AugmentFn]:
    """Build ``augment(generator, features, sensors) -> (features, sensors)``.

    Returns None when the config is disabled or all magnitudes are zero
    (the train step then runs no augmentation at all).
    ``features``: (N, T, V, C>=2) with (x, y[, score]) channels;
    ``sensors``: (N, T, S); both on ``generator``'s device.
    """
    magnitudes = {
        "rotate_deg": cfg.rotate_deg, "scale": cfg.scale,
        "translate": cfg.translate, "joint_jitter": cfg.joint_jitter,
        "flip_prob": cfg.flip_prob, "sensor_noise": cfg.sensor_noise,
        "sensor_scale": cfg.sensor_scale,
    }
    negative = sorted(k for k, v in magnitudes.items() if v < 0)
    if negative:
        # a sign mistake must not silently disable the transform: every
        # magnitude is a half-range (draws are already symmetric/±)
        raise ValueError(
            f"augment magnitudes must be >= 0 (draws are symmetric ranges); "
            f"got negative {negative}"
        )
    active = cfg.enabled and any(v > 0 for v in magnitudes.values())
    if not active:
        return None
    if cfg.flip_prob > 0 and layout not in FLIP_PERMUTATIONS:
        raise ValueError(
            f"augment.flip_prob needs a left/right joint pairing for layout "
            f"{layout!r}; known: {sorted(FLIP_PERMUTATIONS)} — add the "
            "permutation to FLIP_PERMUTATIONS or disable flipping"
        )
    flip_perm = FLIP_PERMUTATIONS[layout] if cfg.flip_prob > 0 else None
    rot_rad = math.radians(cfg.rotate_deg)

    def augment(generator, features, sensors):
        n, dev = features.shape[0], features.device

        def uniform(shape, half_range):
            u = torch.rand(shape, generator=generator, device=dev)
            return (2.0 * u - 1.0) * half_range

        xy = features[..., :2]                              # (N, T, V, 2)
        rest = features[..., 2:]

        if cfg.rotate_deg > 0 or cfg.scale > 0:
            # one affine per window: scale * rotation (about the centroid);
            # skipped when both are off so the untouched channels stay
            # bit-identical (no identity-matmul rounding)
            centroid = xy.mean(dim=(1, 2), keepdim=True)    # (N, 1, 1, 2)
            theta = uniform((n,), rot_rad)
            gain = 1.0 + uniform((n,), cfg.scale)
            cos, sin = torch.cos(theta) * gain, torch.sin(theta) * gain
            rot = torch.stack(
                [torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2
            )                                               # (N, 2, 2)
            out = torch.einsum("ntvc,ncd->ntvd", xy - centroid, rot) + centroid
        else:
            out = xy

        if cfg.translate > 0:
            out = out + uniform((n, 1, 1, 2), cfg.translate)
        if cfg.joint_jitter > 0:
            out = out + cfg.joint_jitter * torch.randn(
                out.shape, generator=generator, device=dev)

        feats = torch.cat([out, rest], dim=-1)
        if flip_perm is not None:
            do_flip = torch.rand((n, 1, 1, 1), generator=generator, device=dev) < cfg.flip_prob
            mirrored = feats[:, :, torch.as_tensor(flip_perm, device=dev), :].clone()
            mirrored[..., 0] = -mirrored[..., 0]
            feats = torch.where(do_flip, mirrored, feats)

        if cfg.sensor_noise > 0:
            sensors = sensors + cfg.sensor_noise * torch.randn(
                sensors.shape, generator=generator, device=dev)
        if cfg.sensor_scale > 0:
            sensors = sensors * (1.0 + uniform((n, 1, 1), cfg.sensor_scale))
        return feats, sensors

    return augment
