"""The numbers that decide ``correct``: what the system produced against the
plain reference, each as one worst-case number.

Logits: for each answer, the largest absolute gap over its classes, over
the larger of the reference answer's largest magnitude and the median of
those over all answers; the worst answer is the number.

Training: per leaf (parameter or running statistic), the gap between the
two sides' norms, over the larger of the reference's norm of that leaf and
of the median leaf; the worst leaf is the number.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def logit_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """Worst answer of ``(N, K)`` logits; non-finite program logits read inf."""
    program, reference = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if program.shape != reference.shape:
        raise ValueError(f"answers of shape {program.shape} against {reference.shape}")
    if not np.isfinite(program).all():
        return float("inf")
    scale = np.abs(reference).max(axis=-1)
    scale = np.maximum(scale, np.median(scale))
    return float((np.abs(program - reference).max(axis=-1) / scale).max())


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """Worst leaf of ``|norm_p - norm_r| / max(norm_r, median norm_r)`` over
    the leaves in ``keep`` (all by default), with the worst leaf's name."""
    names = list(reference if keep is None else keep)
    ref = np.asarray([reference[n] for n in names], np.float64)
    prog = np.asarray([program.get(n, 0.0) for n in names], np.float64)
    if not np.isfinite(prog).all():
        return float("inf"), names[int(np.argmin(np.isfinite(prog)))]
    scale = np.maximum(ref, np.median(ref))
    gaps = np.abs(prog - ref) / np.where(scale > 0, scale, 1.0)
    i = int(np.argmax(gaps))
    return float(gaps[i]), names[i]


def value_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]
              ) -> Tuple[float, str]:
    """Worst leaf of ``max|p - r| / max(max|r|, median max|r|)``; 0.0 and
    no leaf's name where there are no leaves (a family without running
    statistics)."""
    names = list(reference)
    if not names and not program:
        return 0.0, ""
    mags = np.asarray([float(reference[n].abs().max()) for n in names])
    scale = np.maximum(mags, np.median(mags))
    gaps = []
    for n, s in zip(names, scale):
        d = (program[n].double() - reference[n].double()).abs().max()
        gaps.append(float(d) / s if s > 0 else float(d))
    gaps = np.nan_to_num(np.asarray(gaps), nan=np.inf)
    i = int(np.argmax(gaps))
    return float(gaps[i]), names[i]


def relative_gap(program: List[float], reference: List[float]) -> float:
    """Worst of ``|p - r| / |r|`` over paired scalars."""
    p, r = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if len(p) != len(r) or not np.isfinite(p).all():
        return float("inf")
    return float((np.abs(p - r) / np.abs(r)).max())


def quiet_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is nought to rounding: under ``share``
    of the median leaf's. RMSprop moves them by round-off alone, so their
    change is no evidence either way."""
    med = float(np.median(list(grad_norms.values())))
    return [n for n, g in grad_norms.items() if g < share * med]
