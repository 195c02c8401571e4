"""Inference kernels of the port: each has a plain PyTorch version beside it
(used for CPU tensors) and a hand-written CUDA kernel (used for CUDA
tensors), built from ``ops/csrc`` at first use by :mod:`.build`."""
