"""Split-TF32 arithmetic and the kernel-side constants of the port's STGCAN
kernels (``ops/stgcan_block.py``, ``ops/fused_backbone_v2.py``), on the CPU.

The CUDA kernels multiply on tensor cores with every float32 operand split
into two TF32 halves. Here: the split itself (bit patterns), the packed
weight layout and its inverse, the emulation of the kernel's arithmetic
against the plain float32 versions at the flagship's full-width shapes
(tolerance 1e-4, the tolerance the kernels are held to on the card; the
emulation sums in float32 in another order and drops the lo*lo term), that
one TF32 product would *not* hold that tolerance, and that constants are
checked where they are packed, once.
"""

import numpy as np
import pytest
import torch

from fall_multimodal_tpu_torch import serve
from fall_multimodal_tpu_torch.graphs import build_adjacency
from fall_multimodal_tpu_torch.models.stgcan import STGCANBackbone, STGCANBlock
from fall_multimodal_tpu_torch.ops import fused_backbone_v2 as bb
from fall_multimodal_tpu_torch.ops import stgcan_block as sb

torch.set_num_threads(1)

TOL = 1e-4


def _he(module, seed):
    """Seeded weights at He's variance, non-trivial biases and BN statistics."""
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


def _block(cin, c, stride, residual, seed=0):
    torch.manual_seed(seed)
    A = torch.tensor(build_adjacency("coco_cut", "spatial"), dtype=torch.float32)
    return sb.fold_block_params(_he(STGCANBlock(cin, c, 3, stride=stride, residual=residual),
                                    seed), A)


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


# ------------------------------------------------------------------ the split

@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_reproduces_a_weight(scale):
    w = _x((257, 33), 1) * scale
    hi, lo = sb.split_tf32(w)
    for half in (hi, lo):                      # 13 zero low mantissa bits: TF32
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi, sb.tf32_round(w))
    assert float(((hi + lo) - w).abs().max() / w.abs().max()) <= 2.0 ** -21
    assert float(((hi - w).abs() / w.abs()).max()) <= 2.0 ** -11     # one half alone: TF32


def test_tf32_round_is_to_nearest_ties_away():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10                           # TF32 spacing at 1
    assert torch.equal(sb.tf32_round(one * (1 + 0.49 * ulp)), one)
    assert torch.equal(sb.tf32_round(one * (1 + 0.5 * ulp)), one * (1 + ulp))
    assert torch.equal(sb.tf32_round(one * (1 + 0.51 * ulp)), one * (1 + ulp))


@pytest.mark.parametrize("k,c", [(8, 8), (19, 36), (9 * 64, 64), (24, 256)])
def test_packed_weight_layout_and_its_inverse(k, c):
    w = _x((k, c), k + c)
    packed = sb.pack_gemm_weight(w)
    k8, cb = (k + 7) // 8, (c + 63) // 64
    assert packed.shape == (cb, k8, 4, 64, 4) and packed.is_contiguous()
    hi, lo = sb.split_tf32(w)
    # per column block of 64 and 8-row block four pieces (hi k 0-3, hi k 4-7, lo,
    # lo), each column's 4 k's together
    for kk, col in ((0, 0), (k - 1, c - 1), (k // 2, c // 3)):
        at = packed[col // 64, kk // 8]
        assert float(at[kk % 8 // 4, col % 64, kk % 4]) == float(hi[kk, col])
        assert float(at[2 + kk % 8 // 4, col % 64, kk % 4]) == float(lo[kk, col])
    uh, ul = sb.unpack_gemm_weight(packed, k, c)
    assert torch.equal(uh, hi) and torch.equal(ul, lo)
    full_h, _ = sb.unpack_gemm_weight(packed, k8 * 8, cb * 64)
    assert float(full_h[k:].abs().sum()) == 0 and float(full_h[:, c:].abs().sum()) == 0


@pytest.mark.parametrize("cin,c,stride,residual", [(3, 64, 1, False), (64, 64, 1, True),
                                                   (64, 128, 2, True), (8, 36, 1, True)],
                         ids=["none", "identity", "proj", "proj_narrow"])
def test_unpacking_gives_back_the_folded_block(cin, c, stride, residual):
    folded, mode = _block(cin, c, stride, residual)
    packed = sb.pack_block(folded, mode, "cpu")
    assert packed.folded is folded and (packed.v, packed.cin, packed.k, packed.c) == (14, cin, 3, c)
    assert len(packed.ptrs) == 14
    assert (packed.ptrs[11] is None) == (mode != "proj")
    back = sb.unpack_block(packed)
    for name in sb.FoldedBlockParams._fields:
        mine, theirs = getattr(back, name), getattr(folded, name)
        if name in ("gcn_w", "tconv_w", "res_w") and theirs is not None:
            assert mine.shape == theirs.shape
            # hi alone is the weight rounded to TF32, exactly, in the original layout
            torch.testing.assert_close(mine, theirs, rtol=2.0 ** -21, atol=0)
        elif name == "A":
            assert torch.equal(mine, theirs)           # rebuilt from its nonzeros
        else:
            assert mine is theirs
    k = folded.A.shape[0]
    want = (folded.A.sum(1).t() @ folded.gcn_b.view(k, c)) * folded.bn1_scale + folded.bn1_shift
    torch.testing.assert_close(packed.g_shift, want, rtol=0, atol=1e-6)
    assert packed.g_shift.shape == (14, c) and packed.y_shift.shape == (c,)


# -------------------------------------------- the emulation, flagship widths

# (Cin, C, T, stride, residual): the nine distinct block shapes of a flagship forward
FLAGSHIP = [(3, 64, 30, 1, False), (2, 64, 29, 1, False), (64, 64, 30, 1, True),
            (64, 64, 29, 1, True), (64, 128, 30, 2, True), (64, 128, 29, 2, True),
            (128, 128, 15, 1, True), (128, 256, 15, 2, True), (256, 256, 8, 1, True)]


@pytest.mark.parametrize("cin,c,t,stride,residual", FLAGSHIP)
def test_split_emulation_matches_the_plain_block(cin, c, t, stride, residual):
    folded, mode = _block(cin, c, stride, residual, seed=c + t)
    x = _x((2, t, 14, cin), cin + t)
    ref = sb.stgcan_block_reference(x, folded, stride, mode)
    out = sb.stgcan_block_emulated(x, folded, stride, mode)
    assert out.shape == ref.shape and float(ref.abs().max()) > 1
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL)


def test_single_tf32_does_not_hold_the_tolerance():
    """Why the kernels split: at C = 256 (K = 2304 for the taps) one TF32
    product per term is off by about 1e-3 on O(1) outputs."""
    folded, mode = _block(256, 256, 1, True, seed=7)
    x = _x((2, 8, 14, 256), 7)
    ref = sb.stgcan_block_reference(x, folded, 1, mode)
    single = sb.stgcan_block_emulated(x, folded, 1, mode, sb.single_tf32_matmul)
    split = sb.stgcan_block_emulated(x, folded, 1, mode)
    assert float((single - ref).abs().max()) > 3 * TOL
    assert float((split - ref).abs().max()) < TOL / 10


@pytest.fixture(scope="module")
def full_backbone():
    torch.manual_seed(3)
    folded = bb.fold_backbone(_he(STGCANBackbone(3, num_classes=2), 3))
    return folded, _x((2, 30, 14, 3), 3)


def test_split_emulation_matches_the_plain_backbone(full_backbone):
    folded, x = full_backbone
    ref = bb.fused_backbone_reference(x, folded)
    assert len(folded.blocks) == 7 and float(ref.abs().max()) > 0.5
    torch.testing.assert_close(bb.fused_backbone_emulated(x, folded), ref, rtol=0, atol=TOL)


def test_single_tf32_backbone_does_not_hold_the_tolerance(full_backbone):
    folded, x = full_backbone
    ref = bb.fused_backbone_reference(x, folded)
    single = bb.fused_backbone_emulated(x, folded, sb.single_tf32_matmul)
    assert float((single - ref).abs().max()) > 3 * TOL


@pytest.mark.parametrize("dense", [False, True], ids=["skeleton", "dense"])
def test_packed_adjacency_lists_the_nonzeros_by_joint(dense):
    A = torch.tensor(build_adjacency("coco_cut", "spatial"), dtype=torch.float32)
    A = _x((3, 5, 5), 2) if dense else A * (1 + 0.1 * _x(tuple(A.shape), 1))
    k, v = A.shape[:2]
    packed, nnz = sb.pack_adjacency(A)
    assert nnz == int((A != 0).sum()) == (75 if dense else 40)
    assert packed.dtype == torch.int32 and packed.numel() == k * v + 1 + 2 * nnz
    offsets = packed[:k * v + 1]
    assert int(offsets[0]) == 0 and int(offsets[-1]) == nnz
    for kk, w in ((0, 0), (1, 3), (2, v - 1)):           # the entries of (k, w) are its column
        lo, hi = int(offsets[kk * v + w]), int(offsets[kk * v + w + 1])
        joints = packed[k * v + 1 + lo: k * v + 1 + hi].long()
        weights = packed[k * v + 1 + nnz + lo: k * v + 1 + nnz + hi].view(torch.float32)
        assert joints.tolist() == (A[kk, :, w] != 0).nonzero().flatten().tolist()
        assert torch.equal(weights, A[kk, joints, w])
    assert torch.equal(sb.unpack_adjacency(packed, k, v), A)


# ------------------------------------------------ checked once, where packed

def test_constants_are_checked_once_at_packing(monkeypatch):
    folded, mode = _block(8, 16, 1, True)
    calls = []
    real = sb.check_constant
    monkeypatch.setattr(sb, "check_constant", lambda *a: (calls.append(a[0]), real(*a))[1])
    packed = sb.pack_block(folded, mode, "cpu")
    assert len(calls) == 16                       # every field of a projecting block
    x = _x((2, 9, 14, 8), 0)
    out = sb.fused_stgcan_block(x, packed)
    assert len(calls) == 16                       # a launch checks x only
    torch.testing.assert_close(out, sb.stgcan_block_reference(x, folded, 1, mode),
                               rtol=0, atol=0)


@pytest.mark.parametrize("broken,error", [
    (lambda f: f._replace(A=f.A.double()), "folded.A must be"),
    (lambda f: f._replace(tconv_w=f.tconv_w[:, :8].contiguous()), "folded.tconv_w has shape"),
    (lambda f: f._replace(res_w=None), "folded.res_w is None"),
    (lambda f: f._replace(gcn_b=f.gcn_b[::2]), "folded.gcn_b must be"),
], ids=["dtype", "shape", "missing", "strided"])
def test_a_bad_constant_is_refused_where_it_is_packed(broken, error):
    folded, mode = _block(8, 16, 1, True)
    with pytest.raises(ValueError, match=error):
        sb.pack_block(broken(folded), mode, "cpu")


def test_a_block_too_wide_for_the_kernel_is_refused_at_packing():
    """The kernel's size limits hold where a block is packed for the card;
    the CPU's plain version takes any width."""
    folded, mode = _block(8, 260, 1, True)
    with pytest.raises(ValueError, match="C <= 256"):
        sb.pack_block(folded, mode, "cuda")
    assert sb.pack_block(folded, mode, "cpu").c == 260


def test_backbone_constants_are_checked_once_at_packing(monkeypatch):
    torch.manual_seed(0)
    stages = ((16, 1, False), (16, 1, True), (32, 2, True))
    folded = bb.fold_backbone(_he(STGCANBackbone(3, stages=stages, num_classes=2), 0))
    calls = []
    real = sb.check_constant
    for module in (sb, bb):
        monkeypatch.setattr(module, "check_constant",
                            lambda *a: (calls.append(a[0]), real(*a))[1])
    packed = bb.pack_backbone(folded, "cpu")
    n = len(calls)
    assert n == 13 + 13 + 16 + 4 and "blocks[2].res_w" in calls and "cls_w" in calls
    x = _x((2, 30, 14, 3), 0)
    out = bb.fused_backbone_forward(x, packed)
    assert len(calls) == n                        # a launch checks x only
    torch.testing.assert_close(out, bb.fused_backbone_reference(x, folded), rtol=0, atol=0)
    assert len(packed.ptrs) == 3 * 14 and list(packed.ints) == [16, 1, 0, 40, 16, 1, 1, 40, 32, 2, 2, 40]
    assert packed.scratch_floats(30) == (30 * 14 * 16, 30 * 14 * 32)
    bad = folded._replace(cls_w=folded.cls_w[:, :1].contiguous())
    with pytest.raises(ValueError, match="cls_w has shape"):
        bb.pack_backbone(bad, "cpu")
    bad = folded._replace(blocks=folded.blocks[:2] + (folded.blocks[2]._replace(
        bn2_shift=folded.blocks[2].bn2_shift.double()),))
    with pytest.raises(ValueError, match=r"blocks\[2\].bn2_shift must be"):
        bb.pack_backbone(bad, "cpu")


# ------------------------------------------------------ full float32 serving

@pytest.mark.parametrize("before", [(True, True), (True, False), (False, False)])
def test_full_float32_switches_tf32_off_and_restores_the_callers_flags(before):
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
        with serve.full_float32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
        with pytest.raises(RuntimeError, match="boom"), serve.full_float32():
            raise RuntimeError("boom")
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
