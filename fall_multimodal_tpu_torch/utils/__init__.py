from fall_multimodal_tpu_torch.utils.logging import create_logger

__all__ = ["create_logger", "import_class"]


def import_class(name: str):
    """Resolve a dotted path to an attribute (reference ``import_class``,
    ``musa_model.py:10-15``), e.g.
    ``import_class("fall_multimodal_tpu_torch.models.MusaModel")``."""
    import importlib

    module_name, _, attr = name.rpartition(".")
    if not module_name:
        raise ValueError(f"expected a dotted path, got {name!r}")
    return getattr(importlib.import_module(module_name), attr)
