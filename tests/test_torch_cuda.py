"""Card-only tests of the port's CUDA kernel (marker ``cuda``); they skip
where there is no GPU. They import neither JAX nor the JAX package, so
they also run on a GPU machine without JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's ``conftest.py`` sets up JAX.) Tolerance
1e-4: the fp32 kernel against the fp32 plain version, summed in another
order; TF32 is off for the plain version's matmuls and convolutions.
"""

import pytest
import torch

from fall_multimodal_tpu_torch.graphs import build_adjacency
from fall_multimodal_tpu_torch.models.stgcan import STGCANBackbone, STGCANBlock
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
from fall_multimodal_tpu_torch.ops.stgcan_block import (
    fold_block_params,
    fused_stgcan_block,
    stgcan_block_reference,
)
from torch_port_helpers import cuda_device  # noqa: F401  (fixture)

TOL = 1e-4


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _randomize(module, seed):
    """Seeded weights with non-trivial biases and BN statistics."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.5 * torch.rand(buf.shape, generator=gen))
        for param in module.parameters():
            param.add_(0.1 * torch.randn(param.shape, generator=gen))
    return module.eval()


# (N, Cin, C, stride, residual, T): the JAX kernel's test cases, then the
# flagship's odd sizes (T=29, Cin=2, N=37, N=1, stride 2 to T=8)
CASES = [
    (8, 64, 64, 1, True, 30),
    (8, 64, 128, 2, True, 30),
    (8, 3, 64, 1, False, 30),
    (6, 16, 16, 1, True, 30),
    (37, 2, 64, 1, False, 29),
    (1, 128, 256, 2, True, 15),
    (3, 256, 256, 1, True, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,cin,cout,stride,residual,t", CASES)
def test_kernel_matches_reference(cuda_device, no_tf32, n, cin, cout, stride,  # noqa: F811
                                  residual, t):
    block = _randomize(STGCANBlock(cin, cout, 3, stride=stride, residual=residual), n)
    block = block.to(cuda_device)
    A = torch.tensor(build_adjacency("coco_cut", "spatial"), dtype=torch.float32)
    folded, mode = fold_block_params(block, A.to(cuda_device))
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn((n, t, 14, cin), generator=gen).to(cuda_device)
    before = fused_stgcan_block.launches
    out = fused_stgcan_block(x, folded, stride=stride, residual_mode=mode)
    torch.cuda.synchronize()
    assert fused_stgcan_block.launches == before + 1
    torch.testing.assert_close(out, stgcan_block_reference(x, folded, stride, mode),
                               rtol=0, atol=TOL)
    with torch.no_grad():
        torch.testing.assert_close(out, block(x, A.to(cuda_device)), rtol=0, atol=TOL)


@pytest.mark.cuda
def test_backbone_runs_every_block_through_the_kernel(cuda_device, no_tf32):  # noqa: F811
    backbone = _randomize(STGCANBackbone(3), 0).to(cuda_device)
    fused = FusedBackbone(backbone)
    x = torch.randn((5, 30, 14, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda_device)
    before = fused_stgcan_block.launches
    out = fused(x)
    torch.cuda.synchronize()
    assert fused_stgcan_block.launches == before + 7
    with torch.no_grad():
        torch.testing.assert_close(out, backbone(x), rtol=0, atol=TOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):  # noqa: F811
    A = torch.tensor(build_adjacency("coco_cut", "spatial"), dtype=torch.float32)
    x = torch.zeros((2, 9, 14, 8), device=cuda_device)
    for cout, error in ((512, "C <= 256"), (64, "on cuda")):
        block = _randomize(STGCANBlock(8, cout, 3), 0).to(cuda_device)
        folded, mode = fold_block_params(block, A.to(cuda_device))
        if cout == 64:
            folded = folded._replace(A=folded.A.cpu())
        before = fused_stgcan_block.launches
        with pytest.raises(ValueError, match=error):
            fused_stgcan_block(x, folded, residual_mode=mode)
        assert fused_stgcan_block.launches == before
