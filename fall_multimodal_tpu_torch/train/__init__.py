from fall_multimodal_tpu_torch.train.losses import (
    cross_entropy,
    cross_entropy_per_sample,
    one_hot_if_needed,
    smooth_labels,
)
from fall_multimodal_tpu_torch.train.loop import (
    EvalResult,
    FitResult,
    evaluate,
    fit,
    k_copies_logits,
    make_eval_epoch,
    make_train_epoch,
    make_train_step,
)
from fall_multimodal_tpu_torch.train.metrics import (
    as_class_indices,
    classification_report,
    confusion_matrix,
    prf_from_confusion,
    save_confusion_png,
    top_k_accuracy,
)
from fall_multimodal_tpu_torch.train.optim import Optimizer, build_optimizer, build_schedule
from fall_multimodal_tpu_torch.train.state import TrainState, create_train_state, param_count

__all__ = [
    "EvalResult",
    "FitResult",
    "Optimizer",
    "TrainState",
    "as_class_indices",
    "build_optimizer",
    "build_schedule",
    "classification_report",
    "confusion_matrix",
    "create_train_state",
    "cross_entropy",
    "cross_entropy_per_sample",
    "evaluate",
    "fit",
    "k_copies_logits",
    "make_eval_epoch",
    "make_train_epoch",
    "make_train_step",
    "one_hot_if_needed",
    "param_count",
    "prf_from_confusion",
    "save_confusion_png",
    "smooth_labels",
    "top_k_accuracy",
]
