from fall_multimodal_tpu_torch.configs.config import (
    AugmentConfig,
    Config,
    DataConfig,
    GraphConfig,
    ModelConfig,
    OptimConfig,
    SchedulerConfig,
    TrainConfig,
    load_config,
    preset_path,
)

__all__ = [
    "AugmentConfig",
    "Config",
    "DataConfig",
    "GraphConfig",
    "ModelConfig",
    "OptimConfig",
    "SchedulerConfig",
    "TrainConfig",
    "load_config",
    "preset_path",
]
