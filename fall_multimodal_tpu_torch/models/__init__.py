from fall_multimodal_tpu_torch.models.fusion import (
    STGCANClassifier,
    ThreeStreamGSTCAN,
    TransformerEnsemble,
    TwoStreamSTGCAN,
)
from fall_multimodal_tpu_torch.models.musa import MusaModel
from fall_multimodal_tpu_torch.models.registry import (
    build_model,
    model_names,
    uses_sensor,
)
from fall_multimodal_tpu_torch.models.skeleton_transformer import SkeletonTransformer
from fall_multimodal_tpu_torch.models.stgcan import (
    STGCAN_STAGES,
    STGCANBackbone,
    STGCANBlock,
    motion_stream,
)
from fall_multimodal_tpu_torch.models.targcn import TARGCN

__all__ = [
    "MusaModel",
    "SkeletonTransformer",
    "TARGCN",
    "TransformerEnsemble",
    "STGCAN_STAGES",
    "STGCANBackbone",
    "STGCANBlock",
    "STGCANClassifier",
    "ThreeStreamGSTCAN",
    "TwoStreamSTGCAN",
    "build_model",
    "model_names",
    "motion_stream",
    "uses_sensor",
]
