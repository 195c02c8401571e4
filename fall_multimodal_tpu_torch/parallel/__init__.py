from fall_multimodal_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FOLD_AXIS,
    Mesh,
    global_batch_stats,
    initialize_distributed,
    make_mesh,
    make_parallel_eval_epoch,
    make_parallel_train_epoch,
    make_parallel_train_step,
    replicate_data,
    replicate_state,
    shard_data,
)

__all__ = [
    "DATA_AXIS",
    "FOLD_AXIS",
    "Mesh",
    "global_batch_stats",
    "initialize_distributed",
    "make_mesh",
    "make_parallel_eval_epoch",
    "make_parallel_train_epoch",
    "make_parallel_train_step",
    "replicate_data",
    "replicate_state",
    "shard_data",
]
