from fall_multimodal_tpu_torch.utils.logging import create_logger

__all__ = ["create_logger"]
