from fall_multimodal_tpu_torch.models.fusion import ThreeStreamGSTCAN
from fall_multimodal_tpu_torch.models.registry import (
    build_model,
    model_names,
    uses_sensor,
)
from fall_multimodal_tpu_torch.models.stgcan import (
    STGCAN_STAGES,
    STGCANBackbone,
    STGCANBlock,
    motion_stream,
)

__all__ = [
    "STGCAN_STAGES",
    "STGCANBackbone",
    "STGCANBlock",
    "ThreeStreamGSTCAN",
    "build_model",
    "model_names",
    "motion_stream",
    "uses_sensor",
]
