"""Card-only tests of the port's CUDA kernels (marker ``cuda``); they skip
where there is no GPU. They import neither JAX nor the JAX package, so
they also run on a GPU machine without JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's ``conftest.py`` sets up JAX.) Tolerance
1e-4: a kernel that multiplies in split TF32 (float32 accuracy) against its
fp32 plain version, summed in another order; TF32 is off for the plain
version's matmuls and convolutions. The whole-backbone kernel's logits are
O(1) here, so 1e-4 is absolute on them.
"""

import numpy as np
import pytest
import torch

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.graphs import build_adjacency
from fall_multimodal_tpu_torch.models import build_model
from fall_multimodal_tpu_torch.models.init import seeded_model
from fall_multimodal_tpu_torch.models.stgcan import STGCANBackbone, STGCANBlock
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import (
    fold_backbone,
    fused_backbone_forward,
    fused_backbone_reference,
)
from fall_multimodal_tpu_torch.ops.stgcan_block import (
    fold_block_params,
    fused_stgcan_block,
    stgcan_block_reference,
)
from fall_multimodal_tpu_torch.serve import Predictor
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
    # what the tiling leaves ragged: rows not a multiple of 16 or of a pass,
    # widths narrower than a column tile or not a multiple of 8, two passes
    # of rows, a projection from Cin = 3, and one sample with every CTA of
    # its cluster at work
    (1, 16, 16, 1, True, 30),
    (2, 36, 36, 1, True, 9),
    (2, 8, 36, 2, True, 11),
    (1, 3, 16, 2, True, 5),
    (2, 64, 64, 1, True, 80),
    (1, 100, 200, 1, True, 3),
    (1, 64, 64, 1, True, 30),
    (1, 128, 128, 1, True, 15),
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
@pytest.mark.parametrize("v", [5, 17, 25])
def test_kernel_takes_an_odd_joint_count(cuda_device, no_tf32, v):  # noqa: F811
    """Joint pairs in the adjacency contraction need an even V; odd V takes
    the one-joint path, and rows stop lining up with frames."""
    block = _randomize(STGCANBlock(24, 40, 3, stride=2, residual=True), v).to(cuda_device)
    gen = torch.Generator().manual_seed(v)
    A = (torch.randn((3, v, v), generator=gen) / v ** 0.5).to(cuda_device)
    folded, mode = fold_block_params(block, A)
    x = torch.randn((3, 12, v, 24), generator=gen).to(cuda_device)
    out = fused_stgcan_block(x, folded, stride=2, residual_mode=mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, stgcan_block_reference(x, folded, 2, mode), rtol=0, atol=TOL)


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


# ------------------------------------------- the whole-backbone kernel

SHORT = ((64, 1, False), (128, 2, True))
NARROW_RES = ((16, 1, True), (16, 1, True), (32, 2, True))   # block 0 projects its residual


def _scaled(module, seed):
    """Seeded weights at He's variance with non-trivial BN statistics, so
    that logits stay O(1) through seven blocks."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for param in module.parameters():
            if param.dim() >= 2:
                param.mul_(6 ** 0.5)
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.3 * torch.rand(buf.shape, generator=gen))
    return module.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1, 37])
@pytest.mark.parametrize("classes,stages,cin", [(2, None, 3), (11, None, 3), (3, SHORT, 3),
                                                (5, NARROW_RES, 8)],
                         ids=["urfall", "harup", "short_plan", "block0_residual"])
def test_backbone_kernel_matches_reference(cuda_device, no_tf32, n, classes, stages,  # noqa: F811
                                           cin):
    torch.manual_seed(classes)
    kw = {} if stages is None else {"stages": stages}
    backbone = _scaled(STGCANBackbone(cin, num_classes=classes, **kw), n).to(cuda_device)
    folded = fold_backbone(backbone)
    x = torch.randn((n, 30, 14, cin), generator=torch.Generator().manual_seed(n))
    x = x.to(cuda_device)
    k2, k1 = fused_backbone_forward.launches, fused_stgcan_block.launches
    out = fused_backbone_forward(x, folded)
    torch.cuda.synchronize()
    assert fused_backbone_forward.launches == k2 + 1       # one launch per forward
    assert fused_stgcan_block.launches == k1
    assert out.shape == (n, classes) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, fused_backbone_reference(x, folded), rtol=0, atol=TOL)
    with torch.no_grad():
        torch.testing.assert_close(out, backbone(x), rtol=0, atol=TOL)


@pytest.mark.cuda
def test_backbone_kernel_refuses_what_it_does_not_take(cuda_device):  # noqa: F811
    backbone = _scaled(STGCANBackbone(3, num_classes=2, stages=SHORT), 0).to(cuda_device)
    folded = fold_backbone(backbone)
    x = torch.zeros((2, 30, 14, 3), device=cuda_device)
    broken = [
        (folded._replace(cls_w=folded.cls_w[:, :1].contiguous()), "cls_w has shape"),
        (folded._replace(data_bn_scale=folded.data_bn_scale.cpu()), "on cuda"),
        (folded._replace(blocks=(folded.blocks[0], folded.blocks[1]._replace(
            tconv_w=folded.blocks[1].tconv_w[:, :64].contiguous()))), r"blocks\[1\].tconv_w"),
        (folded._replace(blocks=(folded.blocks[0]._replace(
            gcn_b=folded.blocks[0].gcn_b.double()), folded.blocks[1])), r"blocks\[0\].gcn_b"),
    ]
    for bad, error in broken:
        before = fused_backbone_forward.launches
        with pytest.raises(ValueError, match=error):
            fused_backbone_forward(x, bad)
        assert fused_backbone_forward.launches == before
    assert fused_backbone_forward(x[:0], folded).shape == (0, 2)


# ------------------------------------------------- full float32 when served

@pytest.mark.cuda
def test_predictor_is_full_float32_under_default_tf32_flags(cuda_device):  # noqa: F811
    """No ``no_tf32`` fixture: cuDNN may use TF32 (PyTorch's default), the
    flagship's sensor head is Conv1d + LSTM, and the served logits still
    agree with the CPU Predictor; the caller's flags are left as they were."""
    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    torch.manual_seed(0)
    sd = _scaled(build_model(cfg), 0).state_dict()
    d = cfg.data
    rng = np.random.default_rng(0)
    skel = rng.normal(size=(4, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(4, d.seq_len, d.sensor_dim)).astype(np.float32)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        got = Predictor(cfg, sd, batch_size=4, device=cuda_device).predict_logits(skel, sens)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    want = Predictor(cfg, sd, batch_size=4, device="cpu").predict_logits(skel, sens)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ----------------------------------------------------------------- training

def _train_data(cfg, n):
    from fall_multimodal_tpu_torch.data import make_synthetic

    d = cfg.data
    return make_synthetic(n_windows=n, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          seed=0)


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu_under_default_tf32_flags(cuda_device):  # noqa: F811
    """Three float32 steps of the full-width flagship with cuDNN allowed to
    use TF32 (PyTorch's default), each from the CPU's state (weights,
    running statistics, RMSprop's averages: RMSprop turns float differences
    of tiny gradients into steps of up to lr, so free-running runs part).
    The train step switches TF32 off for itself, so each loss agrees with
    the CPU at 1e-4 relative, and the gradient vectors at 2e-3 relative L2:
    the flagship's float32 gradients, on the card and on the CPU alike, sit
    4.4e-4 to 4.8e-4 from float64 (``experiments/torch_train_profile.py``);
    the caller's flags are left as they were."""
    import copy

    from fall_multimodal_tpu_torch.data import gather_batch, to_device
    from fall_multimodal_tpu_torch.interop import load_into
    from fall_multimodal_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    sd = create_train_state(cfg, build_optimizer(cfg), seed=3, device="cpu").model.state_dict()
    data = _train_data(cfg, 96)
    step = make_train_step(softmax_before_ce=True)
    states = []
    for device in (cuda_device, torch.device("cpu")):
        state = create_train_state(cfg, build_optimizer(cfg), device=device)
        load_into(state.model, sd)
        states.append((state, to_device(data, device)))
    (card, card_data), (cpu, cpu_data) = states
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        for i in range(3):
            card.model.load_state_dict(cpu.model.state_dict())
            card.optimizer.load_state_dict(copy.deepcopy(cpu.optimizer.state_dict()))
            idx = np.arange(32 * i, 32 * i + 32)
            _, m_card = step(card, gather_batch(card_data, torch.as_tensor(idx, device=cuda_device)))
            _, m_cpu = step(cpu, gather_batch(cpu_data, torch.as_tensor(idx)))
            np.testing.assert_allclose(float(m_card["loss"]), float(m_cpu["loss"]), rtol=1e-4)
            diff = sum(float(((p.grad.cpu() - q.grad) ** 2).sum())
                       for p, q in zip(card.model.parameters(), cpu.model.parameters()))
            norm = sum(float((q.grad ** 2).sum()) for q in cpu.model.parameters())
            assert (diff / norm) ** 0.5 <= 2e-3
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("preset,k1,k2", [("gstcan_urfall_3stream", 14, 0),
                                          ("default_urfall", 0, 1)])
def test_trained_weights_serve_through_the_kernels(cuda_device, no_tf32, tmp_path,  # noqa: F811
                                                   preset, k1, k2):
    """A short ``run_fold`` on the card, then its best checkpoint through
    ``Predictor``: the kernels launch as the family's serving path says, and
    the logits equal the trainer's eval forward at 1e-4."""
    import dataclasses

    from fall_multimodal_tpu_torch.data import split_dataset, to_device
    from fall_multimodal_tpu_torch.train.cv import run_fold
    from fall_multimodal_tpu_torch.utils.checkpoint import Checkpointer

    cfg = load_config(preset_path(preset))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=1))
    data = _train_data(cfg, 256)
    splits = {k: to_device(v, cuda_device) for k, v in split_dataset(data).items()}
    ckpt = Checkpointer(str(tmp_path))
    result = run_fold(cfg, splits, checkpointer=ckpt, device=cuda_device)
    assert np.isfinite(result.history["train_loss"]).all()
    pred = Predictor.from_torch_checkpoint(cfg, ckpt.file("best"), batch_size=64,
                                           device=cuda_device)
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    got = pred.predict_logits(data.features[:64], data.sensors[:64])
    assert (fused_stgcan_block.launches, fused_backbone_forward.launches) == (k1, k2)
    with torch.no_grad():
        want = result.best_state.model.eval()(
            torch.from_numpy(data.features[:64]).to(cuda_device),
            torch.from_numpy(data.sensors[:64]).to(cuda_device)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ------------------------------------------- Gen-3 / Gen-1 families, k-copies

GEN3 = {"musa": ("musa_harup", None), "musa_ablation": ("musa_ablation_harup", None),
        "targcn": ("targcn_harup", None),
        "skeleton_transformer": ("skeleton_transformer_harup", None),
        "skeleton_transformer_factorized": ("skeleton_transformer_harup",
                                            "skeleton_transformer_factorized"),
        "transformer_ensemble": ("transformer_ensemble_harup", None)}


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(GEN3))
def test_gen3_family_on_the_card_matches_the_cpu(cuda_device, family):  # noqa: F811
    """Each Gen-3 / Gen-1 family at its preset's full width (seeded weights,
    running statistics from one train-mode pass), under PyTorch's default
    TF32 flags: the card's ``Predictor`` against the CPU's at 1e-4, no
    kernel launched (these families run as plain modules)."""
    import dataclasses

    preset, name = GEN3[family]
    cfg = load_config(preset_path(preset))
    if name:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, name=name))
    sd = seeded_model(cfg).state_dict()
    d = cfg.data
    rng = np.random.default_rng(1)
    skel = rng.normal(size=(16, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(16, d.seq_len, d.sensor_dim)).astype(np.float32)
    pred = Predictor(cfg, sd, batch_size=16, device=cuda_device)
    sens = sens if pred.requires_sensor else None
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    got = pred.predict_logits(skel, sens)
    assert (fused_stgcan_block.launches, fused_backbone_forward.launches) == (0, 0)
    want = Predictor(cfg, sd, batch_size=16, device="cpu").predict_logits(skel, sens)
    assert np.isfinite(got).all() and np.ptp(want, axis=0).min() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("preset,k1,k2", [("gstcan_urfall_3stream", 28, 0),
                                          ("default_urfall", 0, 2)])
def test_k_copies_runs_the_kernels_at_t15(cuda_device, no_tf32, preset, k1, k2):  # noqa: F811
    """``num_copies=2``: each T=15 slice of the window through the family's
    kernels (14 block launches a slice for the flagship, one backbone launch
    for ``stgcan``), the logits against the CPU Predictor's k-copies, and
    every kernel at the slices' shapes (15 -> 8 -> 4 frames; the motion
    stream 14 -> 7 -> 4) against its plain version."""
    cfg = load_config(preset_path(preset))
    torch.manual_seed(0)
    sd = _scaled(build_model(cfg), 0).state_dict()
    d = cfg.data
    rng = np.random.default_rng(2)
    skel = rng.normal(size=(8, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(8, d.seq_len, d.sensor_dim)).astype(np.float32)
    pred = Predictor(cfg, sd, batch_size=8, device=cuda_device, num_copies=2)
    sens = sens if pred.requires_sensor else None
    fused_stgcan_block.launches = fused_backbone_forward.launches = 0
    got = pred.predict_logits(skel, sens)
    assert (fused_stgcan_block.launches, fused_backbone_forward.launches) == (k1, k2)
    want = Predictor(cfg, sd, batch_size=8, device="cpu", num_copies=2).predict_logits(
        skel, sens)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    x = torch.from_numpy(skel[:, :15].copy()).to(cuda_device)
    if pred.folded is not None:
        torch.testing.assert_close(fused_backbone_forward(x, pred.folded),
                                   fused_backbone_reference(x, pred.folded), rtol=0, atol=TOL)
        return
    for fb, t in ((pred.pts_fb, 15), (pred.mot_fb, 14)):
        for folded, stride, mode in fb.blocks:
            xb = torch.randn((8, t, 14, folded.gcn_w.shape[0]),
                             generator=torch.Generator().manual_seed(t)).to(cuda_device)
            torch.testing.assert_close(fused_stgcan_block(xb, folded, stride, mode),
                                       stgcan_block_reference(xb, folded, stride, mode),
                                       rtol=0, atol=TOL)
            t = (t - 1) // stride + 1


# ------------------------------------------- CV folds served, export

@pytest.mark.cuda
@pytest.mark.parametrize("preset,k1,k2", [("gstcan_urfall_3stream", 14, 0),
                                          ("default_urfall", 0, 1)])
def test_cv_fold_checkpoint_serves_through_the_kernels(cuda_device, no_tf32, tmp_path,  # noqa: F811
                                                       preset, k1, k2):
    """``cross_validate`` (2 folds x 1 epoch) on the card, then each fold's
    ``best`` directory through ``Predictor.from_checkpoint``: the kernels
    launch as the family's serving path says, and the logits equal the
    same weights' plain eval forward at 1e-4."""
    from fall_multimodal_tpu_torch.train.cv import cross_validate

    cfg = load_config(preset_path(preset))
    data = _train_data(cfg, 256)
    cross_validate(cfg, data, n_folds=2, epochs=1, checkpoint_dir=str(tmp_path),
                   device=cuda_device)
    x = torch.from_numpy(data.features[:64]).to(cuda_device)
    s = torch.from_numpy(data.sensors[:64]).to(cuda_device)
    for i in range(2):
        pred = Predictor.from_checkpoint(cfg, str(tmp_path / f"fold{i}"), which="best",
                                         batch_size=64, device=cuda_device)
        fused_stgcan_block.launches = fused_backbone_forward.launches = 0
        got = pred.predict_logits(data.features[:64], data.sensors[:64])
        assert (fused_stgcan_block.launches, fused_backbone_forward.launches) == (k1, k2)
        with torch.no_grad():
            want = pred.model(x, s).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.cuda
def test_export_on_the_card_matches_the_predictor_under_default_flags(cuda_device):  # noqa: F811
    """The flagship's plain eval forward exported on the card at batch 128;
    the loaded callable runs in full float32 under PyTorch's default TF32
    flags and equals the Predictor's logits at 1e-4."""
    from fall_multimodal_tpu_torch.serve import export_pt2, load_pt2

    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    sd = seeded_model(cfg).state_dict()
    d = cfg.data
    rng = np.random.default_rng(3)
    skel = rng.normal(size=(128, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(128, d.seq_len, d.sensor_dim)).astype(np.float32)
    forward = load_pt2(export_pt2(cfg, sd, skel.shape, sens.shape, device=cuda_device))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = forward(torch.from_numpy(skel).to(cuda_device),
                      torch.from_numpy(sens).to(cuda_device)).cpu().numpy()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    want = Predictor(cfg, sd, batch_size=128, device=cuda_device).predict_logits(skel, sens)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _fold_states(cfg, folds, device):
    from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state
    from fall_multimodal_tpu_torch.train.cv_vmapped import stack_states

    opt = build_optimizer(cfg)
    states = [create_train_state(cfg, opt, seed=cfg.seed + k, device=device)
              for k in range(folds)]
    return stack_states(states, opt, torch.Generator(device).manual_seed(cfg.seed)), opt


@pytest.mark.cuda
def test_vmapped_flagship_step_on_the_card_matches_the_cpu_and_the_single_fold_step(
        cuda_device):  # noqa: F811
    """Three full-width flagship folds, batch 32: one vmapped step on the card
    against the same step on the CPU (loss 1e-4 relative: cuDNN vs CPU
    summation); then three vmapped steps against the single-fold step of
    each fold taken from the fold's stacked state (``load_fold``; loss 1e-5
    relative: grouped vs plain convolutions)."""
    from fall_multimodal_tpu_torch.data import gather_batch, make_synthetic, to_device
    from fall_multimodal_tpu_torch.train import create_train_state, make_train_step
    from fall_multimodal_tpu_torch.train.cv_vmapped import load_fold, make_fold_train_step

    cfg = load_config(preset_path("gstcan_urfall_3stream"))
    k = 3
    data_np = make_synthetic(n_windows=256, num_classes=2, sensor_dim=4, seed=0)
    rows = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (3, k, 32)))
    step = make_fold_train_step(softmax_before_ce=True)
    losses = []
    for dev in (cuda_device, torch.device("cpu")):
        folds, _ = _fold_states(cfg, k, dev)
        _, m = step(folds, to_device(data_np, dev), rows[0].to(dev))
        losses.append(m["loss"].cpu())
    np.testing.assert_allclose(losses[0].numpy(), losses[1].numpy(), rtol=1e-4)
    data = to_device(data_np, cuda_device)
    folds, opt = _fold_states(cfg, k, cuda_device)
    singles = [create_train_state(cfg, opt, seed=cfg.seed + i, device=cuda_device)
               for i in range(k)]
    single = make_train_step(softmax_before_ce=True)
    for r in rows.to(cuda_device):
        for i, state in enumerate(singles):
            load_fold(folds, i, state)
        want = [float(single(s, gather_batch(data, r[i]))[1]["loss"])
                for i, s in enumerate(singles)]
        _, m = step(folds, data, r)
        np.testing.assert_allclose(m["loss"].cpu().numpy(), want, rtol=1e-5)


@pytest.mark.cuda
def test_fused_fit_on_the_card_equals_the_per_epoch_fit(cuda_device):  # noqa: F811
    """``cnn_bilstm`` at its preset's width on 512 windows, 3 epochs from one
    state: ``fit`` with ``scan_epochs=True`` (the card's default, the scan
    impl) against the per-epoch loop, deterministic cuDNN: the curves, the
    best accuracy, the test accuracy and the best state's tensors within
    1e-6, its step counters and generator state equal."""
    from fall_multimodal_tpu_torch.data import make_synthetic, split_dataset, to_device
    from fall_multimodal_tpu_torch.train import build_optimizer, create_train_state, fit

    cfg = load_config(preset_path("sensor_cnn_bilstm_urfall"))
    d = cfg.data
    data = make_synthetic(n_windows=512, num_classes=d.num_classes, sensor_dim=d.sensor_dim,
                          seed=0)
    splits = {k: to_device(v, cuda_device) for k, v in split_dataset(data, seed=0).items()}
    state0 = create_train_state(cfg, build_optimizer(cfg), seed=0, device=cuda_device)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = [fit(state0.snapshot(), splits, epochs=3, batch_size=cfg.train.batch_size,
                    num_classes=d.num_classes, softmax_before_ce=cfg.model.softmax_output,
                    scan_epochs=se) for se in (False, None)]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    a, b = runs
    for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(a.history[k], b.history[k], atol=1e-6, err_msg=k)
    assert abs(a.best_val_accuracy - b.best_val_accuracy) <= 1e-6
    assert abs(a.test.accuracy - b.test.accuracy) <= 1e-6
    for (k, x), y in zip(a.best_state.model.state_dict().items(),
                         b.best_state.model.state_dict().values()):
        assert float((x.double() - y.double()).abs().max()) <= 1e-6, k
    assert (a.best_state.step, a.best_state.optimizer.gradient_step) == \
        (b.best_state.step, b.best_state.optimizer.gradient_step)
    assert torch.equal(a.best_state.generator.get_state(), b.best_state.generator.get_state())
