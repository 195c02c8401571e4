"""The port's TARGCN (``models/targcn.py``) against the benchmark's plain
reference (``port_bench/reference/targcn.py``, written from the published
per-frame equations), on the CPU: the same state_dict names and shapes; the
same logits under seeded weights drawn at the reference's scales, at a
small size and at the published widths; and two planted faults in the
port, a frame the recurrence skips and the static gated branch dropped,
each reading at least ten times the limit of the benchmark cell's
``logit_gap``."""

import json
import os

import numpy as np
import pytest
import torch

from fall_multimodal_tpu_torch.interop import load_into
from fall_multimodal_tpu_torch.models import targcn as port_targcn
from port_bench.harness import checks, data
from port_bench.harness.weights import seed_weights
from port_bench.reference import targcn as reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 16
SIZES = {"small": ({"rnn_units": 8, "embed_dim": 4}, 3), "published": ({}, 2)}

# Both sides compute one float32 function from one state_dict; the port
# hoists what no frame changes (supports, node-wise weights) out of the
# loop and weighs the static branch by a cached column sum, so the
# operations are the same and only their grouping may differ. On the CPU
# they read 0; on the card, where the library picks other kernels for the
# two sides' shapes, float32 rounding through the 60 dependent steps read
# at most 8e-7 of the logits at the cell's batch. 1e-6 holds that and is a
# tenth of the cell's limit.
TOLERANCE = 1e-6


def cell_limit():
    with open(os.path.join(ROOT, "port_bench", "limits", "targcn-serve-b8192.json")) as fh:
        return json.load(fh)["logit_gap"]["limit"]


def pair(size):
    """The reference and the port at ``size``, holding one seeded state, and
    the windows they score."""
    kwargs, batch = SIZES[size]
    model = {"num_joints": 14, "seq_len": 30, "in_channels": 3, "num_classes": 11,
             "kwargs": kwargs}
    ref = reference.build(model)
    s = reference.sizes(model)
    port = port_targcn.TARGCN(num_classes=11, num_nodes=14, in_channels=3, seq_len=30,
                              **{k: s[k] for k in ("rnn_units", "embed_dim", "output_dim",
                                                   "horizon", "num_layers", "context_steps")})
    x = torch.from_numpy(data.make_windows(batch, 30, 14, 11, 0, 0.15, 16).pose)
    state = seed_weights(ref, SEED, "trained", condition=(x, None), reference=reference)
    load_into(port, state)
    return ref.eval(), port.eval(), x


def gap(port, ref, x):
    with torch.no_grad():
        return checks.logit_gap(port(x).double().numpy(), ref(x).double().numpy())


def test_the_reference_has_the_ports_state_dict_names_and_shapes():
    ref, port, _ = pair("published")
    assert {k: v.shape for k, v in ref.state_dict().items()} == \
        {k: v.shape for k, v in port.state_dict().items()}
    assert sum(p.numel() for p in ref.parameters()) == 3_235_763


@pytest.mark.parametrize("size", sorted(SIZES))
def test_the_port_gives_the_references_logits(size):
    assert TOLERANCE <= cell_limit() / 10
    ref, port, x = pair(size)
    assert gap(port, ref, x) <= TOLERANCE


def skip_frame(frame):
    """A scan that leaves the hidden state as it was at ``frame``."""

    def scan(self, xs, node_emb):
        prepared = self.prepare(node_emb)
        h = xs.new_zeros(xs.shape[0], xs.shape[2], self.hidden_dim)
        out = []
        for i in range(xs.shape[1]):
            if i != frame:
                h = self.step(xs[:, i], h, prepared)
            out.append(h)
        return torch.stack(out, dim=1)

    return scan


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("fault", ["skipped_frame", "no_static_branch"])
def test_a_planted_fault_reads_ten_times_the_cells_limit(monkeypatch, size, fault):
    ref, port, x = pair(size)
    if fault == "skipped_frame":
        monkeypatch.setattr(port_targcn.GraphGRUCell, "scan", skip_frame(14))
    else:
        for module in port.modules():
            if isinstance(module, port_targcn.EmbGCN):
                monkeypatch.setattr(module, "linear", None)
    reading = gap(port, ref, x)
    assert np.isfinite(reading) and reading >= 10 * cell_limit(), reading
