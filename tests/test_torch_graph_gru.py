"""Kernel K4's CPU side (``ops/graph_gru.py``): the packed plain version
against ``GraphGRUCell.scan`` for both graph-GRU layers of the published
TARGCN, the rule that decides which cells the kernel takes, the fragment
layout the kernel reads, and the span and counter that the benchmark's
recurrence metrics read. The kernel itself runs on the card only
(``tests/test_torch_cuda.py``)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.models.init import seeded_model
from fall_multimodal_tpu_torch.models.targcn import GraphGRUCell
from fall_multimodal_tpu_torch.ops.graph_gru import (
    FusedGraphGRU,
    fragments,
    fused_graph_gru,
    gate_outputs,
    gate_rows,
    generate,
    graph_gru_reference,
    kernel_takes,
    pack_graph_gru,
    unfragments,
)

torch.set_num_threads(1)

# the repository's module tolerance (PARITY.md); the packed version sums the
# graph mixing and the static branch in another order than the stock cell
TOL = 2e-5


def _model(seed=0):
    return seeded_model(load_config(preset_path("targcn_harup")), seed=seed).eval()


@pytest.mark.parametrize("layer", [0, 1])      # dim_in 3, then 64
@pytest.mark.parametrize("t", [30, 7])
@pytest.mark.parametrize("batch", [1, 5, 33, 0])
def test_packed_plain_version_equals_the_stock_scan(layer, t, batch):
    model = _model()
    cell, emb = model.encoder.dcrnn_cells[layer], model.node_embeddings
    dim_in = cell.gate.weights_pool.shape[1] - cell.hidden_dim
    gen_x = torch.Generator().manual_seed(100 * layer + 10 * t + batch)
    xs = torch.randn((batch, t, 14, dim_in), generator=gen_x)
    packed = pack_graph_gru(cell)
    launches = fused_graph_gru.launches
    with torch.no_grad():
        want = cell.scan(xs, emb)
        got = fused_graph_gru(xs, packed, generate(packed, emb))
    assert fused_graph_gru.launches == launches                 # the CPU launches nothing
    assert got.shape == (batch, t, 14, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kwargs,takes", [
    ({"dim_in": 3}, True),                       # the published layer 0
    ({"dim_in": 64}, True),                      # the published layer 1
    ({"dim_in": 16, "num_nodes": 5}, True),
    ({"dim_in": 8, "num_nodes": 16}, True),      # 16 nodes fit at 8 inputs
    ({"dim_in": 9, "num_nodes": 16}, False),     # ... not past them (shared memory)
    ({"dim_in": 65}, False),
    ({"gcn_variant": "nogate"}, False),
    ({"gcn_variant": "linear"}, False),
    ({"gcn_variant": "sa"}, False),
    ({"hidden_dim": 32}, False),
    ({"hidden_dim": 128}, False),
    ({"num_nodes": 17, "dim_in": 3}, False),
])
def test_the_kernel_takes_only_the_gated_width_64_cell(kwargs, takes):
    args = {"dim_in": 3, "hidden_dim": 64, "embed_dim": 8, "num_nodes": 14, **kwargs}
    cell = GraphGRUCell(**args)
    assert kernel_takes(cell) is takes
    if not takes:
        with pytest.raises(ValueError, match="takes gated EmbGCN"):
            pack_graph_gru(cell)


def test_fragments_follow_the_mma_a_operand_layout():
    a = torch.arange(32 * 24, dtype=torch.float32).reshape(32, 24)
    frag = fragments(a)
    assert frag.shape == (2, 3, 32, 4)
    for mt, ks, lane in ((0, 0, 0), (1, 2, 31), (0, 1, 13), (1, 0, 6)):
        g, q = divmod(lane, 4)
        rows, cols = 16 * mt + g, 8 * ks + q
        assert frag[mt, ks, lane].tolist() == [a[rows, cols], a[rows + 8, cols],
                                               a[rows, cols + 4], a[rows + 8, cols + 4]]
    assert torch.equal(unfragments(frag), a)
    # an m16 tile of the gate holds z and r of the same eight features
    rows = gate_rows(torch.arange(128))
    assert rows[:16].tolist() == [*range(8), *range(64, 72)]
    assert sorted(rows.tolist()) == list(range(128))
    assert torch.equal(gate_outputs(rows), torch.arange(128))


def test_the_plain_version_reads_the_padded_inputs_and_the_reordered_rows():
    """The generated layout holds zero columns for the inputs past
    ``dim_in`` (3 of the 8 the kernel reads), and the plain version reads the
    node biases in the kernel's row order: moving them by one row changes
    its answer."""
    model = _model()
    cell, emb = model.encoder.dcrnn_cells[0], model.node_embeddings
    packed = pack_graph_gru(cell)
    gen = generate(packed, emb)
    xs = torch.randn((2, 4, 14, 3), generator=torch.Generator().manual_seed(3))
    node_w = gen.node_w.view(14, 12, 9, 32, 4)
    rows = unfragments(node_w)                                   # (14, 12 tiles x 16, 72)
    assert not rows[:, :, 3:8].any()                             # inputs 3..7: padding
    with torch.no_grad():
        base = graph_gru_reference(xs, packed, gen)
        swapped = gen._replace(node_b=gen.node_b[:, torch.roll(torch.arange(192), 1)])
        assert not torch.equal(graph_gru_reference(xs, packed, swapped), base)


def test_the_fused_module_keeps_the_recurrence_span_and_the_step_counter(tmp_path):
    model = _model()
    fused = FusedGraphGRU(model.encoder.dcrnn_cells[0])
    assert not list(fused.parameters())                         # the pack is a plain attribute
    xs = torch.randn((2, 7, 14, 3), generator=torch.Generator().manual_seed(1))
    steps = GraphGRUCell.steps
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        got = fused.scan(xs, model.node_embeddings)
    assert GraphGRUCell.steps == steps + 7
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert [e["name"] for e in spans] == ["targcn.recurrence"]
    # the weight generation runs inside the span: its einsums start there
    span = spans[0]
    einsums = [e for e in events if e.get("ph") == "X" and e["name"] == "aten::einsum"]
    assert einsums and all(span["ts"] <= e["ts"] <= span["ts"] + span["dur"] for e in einsums)
    with torch.no_grad():
        want = model.encoder.dcrnn_cells[0].scan(xs, model.node_embeddings)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_the_wrapper_checks_what_it_is_given():
    model = _model()
    packed = pack_graph_gru(model.encoder.dcrnn_cells[1])
    gen = generate(packed, model.node_embeddings)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_graph_gru(torch.zeros((2, 14, 30, 64)).transpose(1, 2), packed, gen)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_graph_gru(torch.zeros((2, 30, 14, 64), dtype=torch.float64), packed, gen)
    with pytest.raises(ValueError, match="takes"):
        fused_graph_gru(torch.zeros((2, 30, 14, 3)), packed, gen)
    with pytest.raises(ValueError, match="takes"):
        fused_graph_gru(torch.zeros((2, 30, 13, 64)), packed, gen)


def test_a_served_targcn_recurrence_counts_both_layers():
    """The served tree's two ``FusedGraphGRU`` each record one
    ``targcn.recurrence`` span and add T to ``GraphGRUCell.steps``: 60 a
    forward, as the stock cells do."""
    from fall_multimodal_tpu_torch.serve import Predictor

    cfg = load_config(preset_path("targcn_harup"))
    pred = Predictor(cfg, seeded_model(cfg).state_dict(), batch_size=2, device="cpu")
    skel = np.random.default_rng(2).normal(size=(2, 30, 14, 3)).astype(np.float32)
    steps = GraphGRUCell.steps
    got = pred.predict_logits(skel)
    assert GraphGRUCell.steps == steps + 60
    steps = GraphGRUCell.steps
    with torch.no_grad():
        want = pred.model(torch.from_numpy(skel)).numpy()
    assert GraphGRUCell.steps == steps + 60
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
