from fall_multimodal_tpu_torch.data.loaders import (
    kfold_datasets,
    load_csv_windows,
    load_dataset,
    load_pickle_windows,
    split_dataset,
)
from fall_multimodal_tpu_torch.data.pipeline import (
    DeviceData,
    epoch_batch_indices,
    eval_batch_indices,
    eval_batch_mask,
    gather_batch,
    to_device,
)
from fall_multimodal_tpu_torch.data.preprocess import (
    add_center_joint,
    epsilon_smooth,
    scale_pose,
    scale_pose_torch,
    score_weighted_labels,
    segment_continuous,
    seq_label_smoothing,
    sliding_windows,
    window_video,
)
from fall_multimodal_tpu_torch.data.splits import (
    kfold_indices,
    stratified_kfold_indices,
    train_valid_test_split,
)
from fall_multimodal_tpu_torch.data.synthetic import WindowedDataset, make_synthetic

__all__ = [
    "DeviceData",
    "WindowedDataset",
    "add_center_joint",
    "epoch_batch_indices",
    "epsilon_smooth",
    "eval_batch_indices",
    "eval_batch_mask",
    "gather_batch",
    "kfold_datasets",
    "kfold_indices",
    "load_csv_windows",
    "load_dataset",
    "load_pickle_windows",
    "make_synthetic",
    "scale_pose",
    "scale_pose_torch",
    "score_weighted_labels",
    "segment_continuous",
    "seq_label_smoothing",
    "sliding_windows",
    "split_dataset",
    "stratified_kfold_indices",
    "to_device",
    "train_valid_test_split",
    "window_video",
]
