"""Whole-backbone kernel of the port (``ops/fused_backbone_v2.py``) against
the JAX package's whole-backbone kernel and its flax backbone.

The JAX kernel runs as ``tests/test_pallas_kernel.py`` runs it on the CPU
(``interpret=True``), on the three cases of that file's
``TestFusedBackboneV2``: the full seven-block plan, a batch that does not
divide the JAX kernel's tile, and a short two-block plan. The plain version
is compared at rtol = atol = 1e-5, the tolerance of those tests: the same
float32 arithmetic summed in another order (the JAX kernel folds the
adjacency into one dense matrix, the port keeps it factored).

Also here: the wrapper's and the packing's checks on the CPU, and the kernel
libraries' content hash (``ops/build.py``).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.models.stgcan import STGCANBackbone as JaxBackbone
from fall_multimodal_tpu.ops.pallas import fused_backbone_v2 as jk
from fall_multimodal_tpu_torch.interop import _conv1x1_inv, _FlaxReader, _Writer, load_into
from fall_multimodal_tpu_torch.models.stgcan import STGCAN_STAGES, STGCANBackbone
from fall_multimodal_tpu_torch.ops import build
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import (
    FoldedBackbone,
    fold_backbone,
    fused_backbone_forward,
    fused_backbone_reference,
    pack_backbone,
)
from fall_multimodal_tpu_torch.ops.stgcan_block import fused_stgcan_block
from torch_port_helpers import random_init, t, to_numpy

torch.set_num_threads(1)

NARROW = ((16, 1, False), (16, 1, True), (32, 2, True))
SHORT = ((64, 1, False), (128, 2, True))
# (stages, N, samples per program of the JAX kernel): test_pallas_kernel.py:129-172
CASES = {
    "full_plan": (STGCAN_STAGES, 4, 4),
    "n6_tile4": (NARROW, 6, 4),          # 6 % 4 != 0: the JAX kernel falls to a tile of 3
    "short_plan": (SHORT, 8, 8),
}


def port_backbone(variables, stages, num_classes, in_channels=3):
    """A port ``STGCANBackbone`` (eval) carrying a flax backbone's variables."""
    port = STGCANBackbone(in_channels, stages=stages, num_classes=num_classes)
    w = _Writer(_FlaxReader({"bb": variables["params"]}),
                _FlaxReader({"bb": variables["batch_stats"]}))
    w.backbone("", "bb", stages, in_channels, to_numpy(port.A))
    if num_classes is not None:
        w.dense("cls", "bb", "cls", inv=_conv1x1_inv)
    return load_into(port, w.sd).eval()


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    stages, n, spp = CASES[request.param]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, 30, 14, 3)).astype(np.float32)
    jb = JaxBackbone(stages=stages, num_classes=3)
    v = random_init(jb, rng, jnp.asarray(x[:2]), train=False)
    folded = fold_backbone(port_backbone(v, stages, 3))
    return jb, v, x, spp, folded


def test_reference_matches_jax_kernel_in_interpret_mode(case):
    jb, v, x, spp, folded = case
    ref = jk.fused_backbone_forward(jnp.asarray(x), jk.fold_backbone(jb, v),
                                    samples_per_program=spp, interpret=True)
    ours = fused_backbone_reference(t(x), folded)
    assert ours.shape == (len(x), 3)
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_reference_matches_flax_backbone(case):
    jb, v, x, _, folded = case
    ref = np.asarray(jb.apply(v, jnp.asarray(x), train=False))
    assert np.ptp(ref, axis=0).min() > 0.05      # the windows are told apart
    np.testing.assert_allclose(to_numpy(fused_backbone_reference(t(x), folded)), ref,
                               rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version(case):
    *_, x, _, folded = case
    k2, k1 = fused_backbone_forward.launches, fused_stgcan_block.launches
    out = fused_backbone_forward(t(x), pack_backbone(folded, "cpu"))
    assert (fused_backbone_forward.launches, fused_stgcan_block.launches) == (k2, k1)
    torch.testing.assert_close(out, fused_backbone_reference(t(x), folded), rtol=0, atol=0)


def test_fold_shapes_and_plan():
    folded = fold_backbone(STGCANBackbone(3, num_classes=11).eval())
    assert isinstance(folded, FoldedBackbone)
    assert folded.data_bn_scale.shape == folded.data_bn_shift.shape == (14 * 3,)
    assert [b.bn1_scale.shape[0] for b in folded.blocks] == [s[0] for s in STGCAN_STAGES]
    assert folded.stage_plan == ((1, "none"), (1, "identity"), (1, "identity"), (2, "proj"),
                                 (1, "identity"), (2, "proj"), (1, "identity"))
    assert folded.cls_w.shape == (256, 11) and folded.cls_b.shape == (11,)
    assert all(x.is_contiguous() for x in (folded.cls_w, folded.data_bn_scale))


def test_fold_backbone_needs_a_cls_head():
    """A headless backbone folds (K1 runs it a block a launch); K2 refuses
    its fold where it is packed."""
    headless = fold_backbone(STGCANBackbone(3, stages=NARROW).eval())
    assert headless.cls_w is None and headless.cls_b is None
    with pytest.raises(ValueError, match="cls head"):
        pack_backbone(headless, "cpu")


def _narrow_folded():
    return fold_backbone(STGCANBackbone(3, stages=NARROW, num_classes=2).eval())


@pytest.mark.parametrize("make_x,error", [
    (lambda: torch.zeros((2, 30, 14, 3), dtype=torch.float64), "contiguous float32"),
    (lambda: torch.zeros((2, 14, 30, 3)).transpose(1, 2), "contiguous float32"),
    (lambda: torch.zeros((2, 30, 42)), "contiguous float32"),
], ids=["float64", "strided", "rank3"])
def test_wrapper_refuses_bad_inputs(make_x, error):
    before = fused_backbone_forward.launches
    with pytest.raises(ValueError, match=error):
        fused_backbone_forward(make_x(), pack_backbone(_narrow_folded(), "cpu"))
    assert fused_backbone_forward.launches == before


@pytest.mark.parametrize("broken,error", [
    (lambda f: f._replace(stage_plan=f.stage_plan[:2]), "3 blocks for a stage plan of 2"),
    (lambda f: f._replace(stage_plan=((1, "none"), (1, "identity"), (2, "identity"))),
     "identity residual needs"),
    (lambda f: f._replace(stage_plan=((1, "none"), (3, "identity"), (2, "proj"))),
     "stride must be 1 or 2"),
    (lambda f: f._replace(blocks=()), "0 blocks"),
], ids=["plan_length", "identity_width", "stride", "empty"])
def test_wrapper_refuses_a_plan_that_does_not_fit(broken, error):
    with pytest.raises(ValueError, match=error):                # refused where it is packed
        pack_backbone(broken(_narrow_folded()), "cpu")


# ------------------------------------------------------------ ops/build.py

@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """``build`` pointed at a copy of the kernel sources."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", str(copy))
    return copy


def test_every_kernel_source_is_listed_and_on_the_include_path():
    assert set(build.SOURCES) == {"stgcan_block", "fused_backbone", "temporal_transformer",
                                  "graph_gru"}
    for name, path in build.SOURCES.items():
        assert os.path.isfile(path)
        with open(path) as fh:   # K3 and K4 share no device code with K1 and K2
            assert ('#include "stgcan_phases.cuh"' in fh.read()) == (
                name in ("stgcan_block", "fused_backbone"))
    flags = list(build.NVCC_FLAGS)
    assert flags[flags.index("-I") + 1] == build.CSRC_DIR
    assert "arch=compute_90a,code=sm_90a" in flags


@pytest.mark.parametrize("edited", ["stgcan_phases.cuh", "stgcan_block.cu", "fused_backbone.cu",
                                    "temporal_transformer.cu", "graph_gru.cu"])
def test_library_hash_covers_shared_headers(csrc_copy, edited):
    before = {name: build.library_path(name) for name in build.SOURCES}
    assert before == {name: build.library_path(name) for name in build.SOURCES}
    with open(csrc_copy / edited, "a") as fh:
        fh.write("\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    for name in build.SOURCES:
        assert after[name] != before[name], name
        assert os.path.basename(after[name]).startswith(name + "-")


def test_library_path_of_an_unknown_kernel_raises():
    with pytest.raises(KeyError, match="no kernel library"):
        build.library_path("nope")
