"""Compile the PyTorch port's CUDA kernels and compare them with their plain
versions, in under a minute: the short first call after a change to a kernel.

    python3 experiments/torch_kernel_check.py [--time]

Prints what ``-Xptxas=-v`` says of each kernel (registers, spills), then the
max abs error of the block kernel against ``stgcan_block_reference`` and
against the split-TF32 emulation at the flagship's block shapes and at
shapes that leave ragged tiles, and of the whole-backbone kernel on a full
and a narrow plan. ``--time`` adds CUDA-event times at batch 128. Exits
non-zero on the first disagreement above 1e-4. Needs an NVIDIA GPU and
``nvcc``; imports no JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fall_multimodal_tpu_torch.graphs import build_adjacency  # noqa: E402
from fall_multimodal_tpu_torch.models.stgcan import STGCANBackbone, STGCANBlock  # noqa: E402
from fall_multimodal_tpu_torch.ops import build  # noqa: E402
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import (  # noqa: E402
    fold_backbone,
    fused_backbone_forward,
    fused_backbone_reference,
    pack_backbone,
)
from fall_multimodal_tpu_torch.ops.stgcan_block import (  # noqa: E402
    fold_block_params,
    fused_stgcan_block,
    pack_block,
    stgcan_block_emulated,
    stgcan_block_reference,
)

TOL = 1e-4
# (N, Cin, C, stride, residual, T, V); V = 14 is the model's skeleton, the
# last shape has an odd joint count and a random adjacency
SHAPES = [
    (2, 256, 256, 1, True, 8, 14), (2, 3, 64, 1, False, 30, 14), (2, 64, 64, 1, True, 30, 14),
    (2, 64, 128, 2, True, 30, 14), (2, 128, 128, 1, True, 15, 14),
    (2, 128, 256, 2, True, 15, 14), (3, 2, 64, 1, False, 29, 14), (3, 64, 128, 2, True, 29, 14),
    (1, 16, 16, 1, True, 30, 14), (2, 36, 36, 1, True, 9, 14), (2, 8, 36, 2, True, 11, 14),
    (1, 3, 16, 2, True, 5, 14), (2, 64, 64, 1, True, 80, 14), (1, 100, 200, 1, True, 3, 14),
    (2, 24, 40, 2, True, 12, 5),
]


def he_scaled(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for param in module.parameters():
            if param.dim() >= 2:
                param.mul_(6 ** 0.5)
            else:
                param.add_(0.1 * torch.randn(param.shape, generator=gen))
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.3 * torch.rand(buf.shape, generator=gen))
    return module.eval()


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    timed = "--time" in argv
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for name, rep in sorted(build.build_all().items()):
        print(f"{name}: built in {rep['seconds']:.1f} s")
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())
    skeleton = torch.tensor(build_adjacency("coco_cut", "spatial"), dtype=torch.float32)
    bad = 0
    for n, cin, c, stride, residual, t, v in SHAPES:
        A = skeleton if v == 14 else torch.randn(
            (3, v, v), generator=torch.Generator().manual_seed(v)) / v ** 0.5
        A = A.to(dev)
        torch.manual_seed(c + t)
        block = he_scaled(STGCANBlock(cin, c, 3, stride=stride, residual=residual), cin).to(dev)
        folded, mode = fold_block_params(block, A)
        x = torch.randn((n, t, v, cin), generator=torch.Generator().manual_seed(t)).to(dev)
        packed = pack_block(folded, mode, dev)
        out = fused_stgcan_block(x, packed, stride)
        torch.cuda.synchronize()
        err = (out - stgcan_block_reference(x, folded, stride, mode)).abs().max().item()
        emu = (out - stgcan_block_emulated(x, folded, stride, mode)).abs().max().item()
        line = (f"block N={n} Cin={cin} C={c} T={t} V={v} stride={stride} {mode:8s}: vs plain "
                f"{err:.3e}, vs split-TF32 emulation {emu:.3e}")
        if timed:
            xb = torch.randn((128, t, v, cin), device=dev)
            line += f", batch 128: {cuda_ms(lambda: fused_stgcan_block(xb, packed, stride)):.4f} ms"
        print(line + ("" if err <= TOL else "  FAIL"), flush=True)
        bad += not err <= TOL
    for name, kw, cin in (("full", {}, 3),
                          ("narrow", {"stages": ((16, 1, True), (36, 1, True), (32, 2, True))}, 8)):
        torch.manual_seed(1)
        folded = fold_backbone(he_scaled(STGCANBackbone(cin, num_classes=3, **kw), 2).to(dev))
        packed = pack_backbone(folded, dev)
        for n in (1, 5):
            x = torch.randn((n, 30, 14, cin), generator=torch.Generator().manual_seed(n)).to(dev)
            out = fused_backbone_forward(x, packed)
            torch.cuda.synchronize()
            err = (out - fused_backbone_reference(x, folded)).abs().max().item()
            print(f"backbone {name} N={n}: vs plain {err:.3e}" + ("" if err <= TOL else "  FAIL"),
                  flush=True)
            bad += not err <= TOL
        if timed and name == "full":
            for n in (128, 1):
                xb = torch.randn((n, 30, 14, cin), device=dev)
                print(f"backbone full N={n}: "
                      f"{cuda_ms(lambda: fused_backbone_forward(xb, packed)):.4f} ms")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
