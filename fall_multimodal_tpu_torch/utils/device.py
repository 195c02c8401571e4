"""Device selection and float32 switches shared by serving and training."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls, convolutions and RNNs in full float32 inside the
    block: cuDNN's and cuBLAS's TF32 switches off, and back to what the caller
    had on the way out."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
