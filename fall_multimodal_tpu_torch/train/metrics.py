"""Evaluation metrics on the device (counterpart of the JAX package's
``train/metrics.py:19-158``).

Capabilities of the reference metric surface: top-k accuracy
(``Fall_2_Spatial_Temporal_SR/main.py:57-77``), macro precision/recall/F1
(``main_cross_validation.py:251``), micro PRF + specificity + confusion
matrix + per-class report (notebook eval cells, ``GSTCAN_UR_conv.ipynb:6``),
derived from the confusion matrix rather than wrapping sklearn, so the eval
epoch stays on the device; only the final report formats on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def as_class_indices(target: torch.Tensor) -> torch.Tensor:
    """Labels may be ints or (soft) one-hot rows; reduce to class indices."""
    if target.dim() == 1:
        return target.long()
    return target.argmax(dim=-1)


def top_k_accuracy(logits: torch.Tensor, target: torch.Tensor,
                   top_k: Sequence[int] = (1,)) -> torch.Tensor:
    """Fraction of rows whose true class is within the top-k predictions.

    Returns a tensor of shape ``(len(top_k),)``. Soft/one-hot targets are
    collapsed via argmax. Ties rank the higher class index first, as the
    JAX package's reversed stable argsort does.
    """
    true = as_class_indices(target)
    max_k = max(top_k)
    rank = torch.argsort(logits, dim=-1, stable=True).flip(-1)[:, :max_k]
    hits = rank == true[:, None]
    return torch.stack([hits[:, :k].any(dim=-1).float().mean() for k in top_k])


def confusion_matrix(logits_or_pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) counts; rows = true class, cols = predicted."""
    if logits_or_pred.dim() > 1:
        pred = logits_or_pred.argmax(dim=-1)
    else:
        pred = logits_or_pred.long()
    flat = as_class_indices(target) * num_classes + pred
    counts = torch.bincount(flat, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def prf_from_confusion(cm) -> Dict[str, torch.Tensor]:
    """Per-class and aggregate precision/recall/F1/specificity/accuracy.

    Zero-denominator classes contribute 0 (sklearn's ``zero_division=0``).
    Counts are taken in float32, as the JAX package takes them (its int64
    branch needs JAX's 64-bit mode, which it never enables).
    """
    cm = torch.as_tensor(cm).float()
    tp = torch.diagonal(cm)
    fp = cm.sum(dim=0) - tp
    fn = cm.sum(dim=1) - tp
    total = cm.sum()
    tn = total - tp - fp - fn

    def safe_div(a, b):
        return torch.where(b > 0, a / torch.where(b > 0, b, torch.ones_like(b)),
                           torch.zeros_like(a))

    precision = safe_div(tp, tp + fp)
    recall = safe_div(tp, tp + fn)
    f1 = safe_div(2 * precision * recall, precision + recall)
    specificity = safe_div(tn, tn + fp)
    support = cm.sum(dim=1)

    micro_p = safe_div(tp.sum(), (tp + fp).sum())
    micro_r = safe_div(tp.sum(), (tp + fn).sum())
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "specificity": specificity,
        "support": support,
        "accuracy": safe_div(tp.sum(), total),
        "macro_precision": precision.mean(),
        "macro_recall": recall.mean(),
        "macro_f1": f1.mean(),
        "macro_specificity": specificity.mean(),
        "micro_precision": micro_p,
        "micro_recall": micro_r,
        "micro_f1": safe_div(2 * micro_p * micro_r, micro_p + micro_r),
        "weighted_f1": safe_div((f1 * support).sum(), support.sum()),
    }


def classification_report(cm: np.ndarray, class_names: Optional[Sequence[str]] = None) -> str:
    """Host-side formatted per-class report (sklearn-report capability)."""
    stats = {k: v.cpu().numpy() for k, v in prf_from_confusion(np.asarray(cm)).items()}
    n = cm.shape[0]
    names = list(class_names) if class_names else [str(i) for i in range(n)]
    width = max(12, max(len(s) for s in names) + 2)
    lines = [
        f"{'':<{width}}{'precision':>10}{'recall':>10}{'f1-score':>10}"
        f"{'specificity':>12}{'support':>10}"
    ]
    for i, name in enumerate(names):
        lines.append(
            f"{name:<{width}}{stats['precision'][i]:>10.5f}{stats['recall'][i]:>10.5f}"
            f"{stats['f1'][i]:>10.5f}{stats['specificity'][i]:>12.5f}"
            f"{int(stats['support'][i]):>10d}"
        )
    lines.append("")
    lines.append(f"{'accuracy':<{width}}{stats['accuracy']:>40.5f}")
    for agg in ("macro", "micro"):
        lines.append(
            f"{agg + ' avg':<{width}}{stats[agg + '_precision']:>10.5f}"
            f"{stats[agg + '_recall']:>10.5f}{stats[agg + '_f1']:>10.5f}"
        )
    return "\n".join(lines)


def save_confusion_png(
    cm: np.ndarray,
    path: str,
    class_names: Optional[Sequence[str]] = None,
    title: str = "Confusion matrix",
) -> str:
    """Confusion-matrix heatmap PNG (notebook capability,
    ``GSTCAN_UR_conv.ipynb:6``). Requires matplotlib; raises ImportError
    otherwise."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.asarray(cm)
    n = cm.shape[0]
    names = list(class_names) if class_names else [str(i) for i in range(n)]
    fig, ax = plt.subplots(figsize=(max(4, n * 0.8), max(3.5, n * 0.7)))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(n), names, rotation=45, ha="right")
    ax.set_yticks(range(n), names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title(title)
    thresh = cm.max() / 2 if cm.max() else 0.5
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{int(cm[i, j])}", ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
