"""Where a served model meets the kernels (``serve.with_kernels``), for every
registered family, on the CPU: the kernel modules the served tree holds, by
path (K2 at the root of the single-stream ``stgcan``/``stgcn``, K1 for the
points and motion streams of the two- and three-stream models, K3 for
TARGCN's temporal transformer and K4 for each of its graph-GRU layers at its
preset's width, none elsewhere); that
``Predictor.model`` keeps its stock modules and the served tree shares every
weight it does not replace; and that the served logits of two windows equal
the stock forward. The STGCAN families run the narrow stage plan and the
Gen-3 / Gen-1 families the small widths of their other tests
(``test_torch_families.py``, ``test_torch_gen3_models.py``), TARGCN its
preset (the kernels take width 64 only); tolerance 2e-5, those tests'
module tolerance (the plain versions of K1-K4 sum in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.models import STGCANBackbone, model_names
from fall_multimodal_tpu_torch.models.init import seeded_model
from fall_multimodal_tpu_torch.models.targcn import GraphGRUCell, TemporalTransformer
from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import WholeBackbone
from fall_multimodal_tpu_torch.ops.graph_gru import FusedGraphGRU
from fall_multimodal_tpu_torch.ops.temporal_transformer import FusedTemporalTransformer
from fall_multimodal_tpu_torch.serve import Predictor

torch.set_num_threads(1)

TOL = 2e-5
KERNELS = (WholeBackbone, FusedBackbone, FusedTemporalTransformer, FusedGraphGRU)
NARROW = {"stages": ((16, 1, False), (16, 1, True), (32, 2, True))}
SMALL_TRANSFORMER = {"embedding_dim": 16, "n_block": 2}
STREAMS = {"pts_stream": FusedBackbone, "mot_stream": FusedBackbone}
# registry name -> (preset, model kwargs over the preset's, {path: kernel module})
ROUTES = {
    "stgcan": ("default_urfall", NARROW, {"": WholeBackbone}),
    "stgcn": ("default", NARROW, {"": WholeBackbone}),
    "two_stgcan": ("twostream_stgcan", NARROW, STREAMS),
    "two_stgcan_bilstm": ("two_stgcan_bilstm_urfall", NARROW, STREAMS),
    "gstcan_3stream": ("gstcan_urfall_3stream", NARROW, STREAMS),
    "bilstm": ("bilstm", {}, {}),
    "cnn_bilstm": ("sensor_cnn_bilstm_urfall", {}, {}),
    "musa": ("musa_harup", {"embed_dim": 16}, {}),
    "musa_ablation": ("musa_ablation_harup", {"embed_dim": 16}, {}),
    "targcn": ("targcn_harup", {}, {"encoder.trans_layer_T": FusedTemporalTransformer,
                                    "encoder.dcrnn_cells.0": FusedGraphGRU,
                                    "encoder.dcrnn_cells.1": FusedGraphGRU}),
    "skeleton_transformer": ("skeleton_transformer_harup", SMALL_TRANSFORMER, {}),
    "skeleton_transformer_factorized": ("skeleton_transformer_harup", SMALL_TRANSFORMER, {}),
    "transformer_ensemble": ("transformer_ensemble_harup", SMALL_TRANSFORMER, {}),
}


def test_every_registered_family_has_a_route():
    assert sorted(ROUTES) == model_names()


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_the_served_tree_holds_the_kernels_its_family_takes(name):
    preset, kwargs, want = ROUTES[name]
    cfg = load_config(preset_path(preset))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, name=name, kwargs=dict(cfg.model.kwargs, **kwargs)))
    pred = Predictor(cfg, seeded_model(cfg).state_dict(), batch_size=2, device="cpu")
    served = {path: type(m) for path, m in pred.served.named_modules()
              if isinstance(m, KERNELS)}
    assert served == want
    # the loaded model keeps its stock modules where the kernels sit
    assert not any(isinstance(m, KERNELS) for m in pred.model.modules())
    for path in want:
        assert isinstance(pred.model.get_submodule(path),
                          (STGCANBackbone, TemporalTransformer, GraphGRUCell))
    # every weight the served tree holds is the model's own, and only those
    # under a replaced module are not in it
    kept = {id(p) for path, p in pred.model.named_parameters()
            if not any(path.startswith(f"{w}.") or not w for w in want)}
    assert {id(p) for p in pred.served.parameters()} == kept
    assert (pred.served is pred.model) == (not want)
    d = cfg.data
    rng = np.random.default_rng(7)
    skel = rng.normal(size=(2, d.seq_len, d.num_joints, d.in_channels)).astype(np.float32)
    sens = rng.normal(size=(2, d.seq_len, max(d.sensor_dim, 1))).astype(np.float32)
    got = pred.predict_logits(skel, sens if pred.requires_sensor else None)
    with torch.no_grad():
        stock = pred.model(torch.from_numpy(skel), torch.from_numpy(sens)).numpy()
    assert got.shape == (2, d.num_classes)
    np.testing.assert_allclose(got, stock, rtol=0, atol=TOL)
