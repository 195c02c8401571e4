"""The harness takes a configuration of any family the system registers:
the two configurations it measures get the same system configuration and
the same seeded weights, bit for bit, as when it took only STGCAN ones;
every registered family builds from a file with ``kwargs`` and no
``stages``; raw parameters are drawn through the reference's hook, and one
that nothing draws is refused; and a TARGCN cell runs both generators end
to end on the CPU with nothing but new files."""

import hashlib
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

from port_bench import run
from port_bench.harness import checks, core, costs, data
from port_bench.harness.weights import seed_weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SEED = 2 ** 31 + 7

# sha256 of repr(port_config(...)) and of the state_dicts seed_weights draws at
# SEED (the "trained" statistics over 8 windows of data.make_windows(..., 0.15,
# 5), on one CPU thread), as the harness gave them before it took other families
PINS = {
    "gstcan3-serve-b128": {
        "config": "1e1c78c9754c52a7469be2205687a0278f4eda4cfe0f733436dcd1272a966845",
        "init": "235a3b645de595187544509292839726eec7ef4773514911a2d14f89d58e2077",
        "trained": "76e936e63bb5960050b4c13297ed2a6d751b348777959b530d1110fa36befa0e"},
    "stgcan-serve-b128": {
        "config": "95bc87ff0345a10e8b8243637e05961a644a1a83de0b1820a85805add7c5e8b6",
        "init": "81f670ae83253561e70b029849ee3df4d3db43ae4c8c7bd7d7373dbc2e74e874",
        "trained": "67e2cbde7b3b5c8ff5b10baae7d49a92f02c5c50249f50cfc2685c740d7eff1b"},
}


def state_hash(sd):
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(str((v.dtype, tuple(v.shape))).encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", sorted(PINS))
def test_the_measured_configurations_get_the_same_config(cell):
    config = core.load_cell(ROOT, cell, False).config
    digest = hashlib.sha256(repr(core.port_config(config)).encode()).hexdigest()
    assert digest == PINS[cell]["config"]


@pytest.mark.parametrize("scheme", ["init", "trained"])
@pytest.mark.parametrize("cell", sorted(PINS))
def test_the_measured_configurations_get_the_same_weights(one_thread, cell, scheme):
    loaded = core.load_cell(ROOT, cell, False)
    family, m = core.reference(loaded), loaded.config["model"]
    condition = None
    if scheme == "trained":
        w = data.make_windows(8, m["seq_len"], m["num_joints"], m["num_classes"],
                              m["sensor_dim"] if m["uses_sensor"] else 0, 0.15, 5)
        condition = (torch.from_numpy(w.pose),
                     None if w.sensor is None else torch.from_numpy(w.sensor))
    sd = seed_weights(family.build(m), SEED, scheme, condition, reference=family)
    assert state_hash(sd) == PINS[cell][scheme]


# a preset of (or next to) each registered family, and constructor settings
# small enough to build and run two windows quickly
FAMILIES = {
    "stgcan": ("default", {"dropout": 0.0}),
    "stgcn": ("default", {"dropout": 0.0}),
    "two_stgcan": ("twostream_stgcan", {"dropout": 0.0}),
    "two_stgcan_bilstm": ("two_stgcan_bilstm_harup", {"dropout": 0.0}),
    "gstcan_3stream": ("gstcan_urfall_3stream", {"dropout": 0.0}),
    "bilstm": ("bilstm", {"hidden_size": 8}),
    "cnn_bilstm": ("sensor_cnn_bilstm_urfall", {"hidden_size": 8}),
    "musa": ("musa_harup", {"embed_dim": 8}),
    "musa_ablation": ("musa_ablation_harup", {"embed_dim": 8}),
    "targcn": ("targcn_harup", {"rnn_units": 8, "embed_dim": 4}),
    "skeleton_transformer": ("skeleton_transformer_harup", {"embedding_dim": 8, "n_block": 2}),
    "skeleton_transformer_factorized": ("skeleton_transformer_harup",
                                        {"embedding_dim": 8, "n_block": 2}),
    "transformer_ensemble": ("transformer_ensemble_harup", {"embedding_dim": 8, "n_block": 2}),
}


def minimal_config(family, preset, kwargs, **model):
    """A configuration file's content with ``kwargs`` and no ``stages``."""
    return {
        "port_preset": preset, "reference": "none", "step_reference": "rmsprop_step",
        "model": {"family": family, "in_channels": 3, "num_joints": 14, "seq_len": 30,
                  "num_classes": 11, "sensor_dim": 15, "uses_sensor": False,
                  "kwargs": kwargs, **model},
        "train": {"batch_size": 8, "epochs": 100, "softmax_output": False, "max_norm": 100.0,
                  "dtype": "float32", "drop_last": True},
        "optim": {"type": "rmsprop", "lr": 0.001, "rms_decay": 0.99, "eps": 1e-08,
                  "momentum": 0.0, "weight_decay": 0.0},
    }


def test_every_registered_family_has_a_case():
    from fall_multimodal_tpu_torch.models.registry import model_names

    assert sorted(FAMILIES) == model_names()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_registered_family_builds_from_kwargs_without_stages(family):
    from fall_multimodal_tpu_torch.configs import load_config, preset_path
    from fall_multimodal_tpu_torch.models.registry import build_model

    preset, kwargs = FAMILIES[family]
    cfg = core.port_config(minimal_config(family, preset, kwargs))
    assert cfg.model.name == family
    preset_kwargs = load_config(preset_path(preset)).model.kwargs
    assert cfg.model.kwargs == {**preset_kwargs, **kwargs}
    assert "stages" not in cfg.model.kwargs
    model = build_model(cfg).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = model(torch.rand(2, 30, 14, 3, generator=gen),
                    torch.rand(2, 30, 15, generator=gen))
    assert out.shape == (2, 11) and torch.isfinite(out).all()


# the raw parameters of two or more dimensions that a family's reference has
# to yield from raw_leaves, as the system's modules name them
NEEDS_A_HOOK = {
    "musa": {"edge"}, "musa_ablation": {"edge"},
    "skeleton_transformer": {"relative_position_bias_table"},
    "skeleton_transformer_factorized": {"relative_position_bias_table"},
    "transformer_ensemble": {"relative_position_bias_table"},
    "targcn": {"bias_pool", "node_embeddings", "weights_pool"},
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_seed_weights_refuses_a_family_whose_raw_parameters_no_hook_yields(family):
    from fall_multimodal_tpu_torch.models.registry import build_model

    preset, kwargs = FAMILIES[family]
    model = build_model(core.port_config(minimal_config(family, preset, kwargs)))
    needs = NEEDS_A_HOOK.get(family, set())
    for scheme in ("init", "trained") if needs else ():       # refused before any draw
        with pytest.raises(ValueError, match="|".join(sorted(needs))):
            seed_weights(model, SEED, scheme)

    def hook(model, scheme):
        for name, p in model.named_parameters():
            if p.dim() >= 2 and name.split(".")[-1] in needs:
                yield p, 0.1, 0.0

    seed_weights(model, SEED, "init", reference=types.SimpleNamespace(raw_leaves=hook))


class Raw(nn.Module):
    """A linear layer beside raw parameters no module-type rule draws."""

    def __init__(self, pool_shape=(3, 4)):
        super().__init__()
        self.linear = nn.Linear(4, 2)
        self.pool = nn.Parameter(torch.zeros(pool_shape))
        self.offset = nn.Parameter(torch.zeros(5))

    def forward(self, x):
        return self.linear(x)


def pool_leaves(model, scheme):
    yield model.pool, 0.5, 0.25


def test_raw_leaves_are_drawn_after_the_module_leaves_from_one_draw():
    model = Raw()
    sd = seed_weights(model, SEED, "init", reference=types.SimpleNamespace(raw_leaves=pool_leaves))
    u = torch.rand(8 + 2 + 12, generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    torch.testing.assert_close(sd["linear.weight"], u[:8].view(2, 4) / 2, rtol=0, atol=0)
    torch.testing.assert_close(sd["linear.bias"], u[8:10] / 2, rtol=0, atol=0)
    torch.testing.assert_close(sd["pool"], u[10:].view(3, 4) * 0.5 + 0.25, rtol=0, atol=0)
    # a model without the raw leaf draws its linear layer exactly as before
    plain = nn.Module()
    plain.linear = nn.Linear(4, 2)
    alone = seed_weights(plain, SEED, "init")
    torch.testing.assert_close(alone["linear.weight"], sd["linear.weight"], rtol=0, atol=0)
    assert not sd["offset"].any()          # a 1-D zero leaf (a shift) is allowed


@pytest.mark.parametrize("value", [0.0, 1.0])
def test_a_parameter_nothing_draws_is_refused(value):
    model = Raw()
    model.pool.data.fill_(value)          # left at a constructor's zeros, or ones as musa's edge
    with pytest.raises(ValueError, match="'pool'.*raw_leaves"):
        seed_weights(model, SEED, "init")
    seed_weights(Raw(pool_shape=(7,)), SEED, "init")        # one dimension: a bias or shift


@pytest.mark.parametrize("scheme", ["init", "trained"])
def test_edge_importance_alone_keeps_its_constructor_value_under_init(scheme):
    model = Raw(pool_shape=(7,))
    model.edge_importance = nn.ParameterList([nn.Parameter(torch.ones(3, 3))])
    sd = seed_weights(model, SEED, scheme, condition=(torch.zeros(1, 4),))
    assert bool((sd["edge_importance.0"] == 1).all()) == (scheme == "init")


def test_value_gap_without_leaves_reads_zero():
    assert checks.value_gap({}, {}) == (0.0, "")


def test_forward_flops_of_an_uncounted_family_names_the_file_to_add(tmp_path):
    model = {"family": "musa", "seq_len": 30}
    with pytest.raises(ValueError, match=r"forward_flops\(model\).*port_bench/reference/"):
        costs.forward_flops(model, 3, 40)
    bare = tmp_path / "bare.py"
    bare.write_text("def build(model):\n    return None\n")
    with pytest.raises(ValueError, match=r"forward_flops\(model\).*bare\.py"):
        costs.forward_flops(dict(model, reference_file=str(bare)), 3, 40)
    counted = tmp_path / "counted.py"
    counted.write_text("def forward_flops(model):\n    return 1000 * model['seq_len']\n")
    assert costs.forward_flops(dict(model, reference_file=str(counted)), 3, 40) == 30000.0


# ------------------------------------------------------------- TARGCN by files alone

STAND_IN = '''"""Stand-in for a TARGCN reference in a test: the system's own module,
with its raw parameters drawn as ``models/init.py:seeded_model`` scales them."""

from fall_multimodal_tpu_torch.models.targcn import TARGCN


def build(model):
    return TARGCN(num_classes=model["num_classes"], num_nodes=model["num_joints"],
                  in_channels=model["in_channels"], seq_len=model["seq_len"],
                  **model["kwargs"])


def raw_leaves(model, scheme):
    for name, p in model.named_parameters():
        if name.endswith("weights_pool"):
            yield p, 3 ** 0.5 * (p.shape[0] * p.shape[1]) ** -0.5, 0.0
        elif name.endswith("bias_pool"):
            yield p, 0.1 * 3 ** 0.5 * p.shape[0] ** -0.5, 0.0
        elif name == "node_embeddings":
            yield p, 3 ** 0.5, 0.0


def forward_flops(model):
    return 1.0e6
'''

TARGCN_TINY = dict(
    minimal_config("targcn", "targcn_harup", {"rnn_units": 8, "embed_dim": 4, "num_layers": 2}),
    name="targcn_tiny", reference="targcn_standin")

CELLS = [
    {"name": "targcn-serve-b4", "config": "targcn_tiny", "traffic": "serve_b4", "chips": 1,
     "why": "a test cell"},
    {"name": "targcn-train-b8", "config": "targcn_tiny", "traffic": "train_b8", "chips": 1,
     "why": "a test cell"},
]


def targcn_checkout(tmp_path):
    """A copy of the benchmark with a TARGCN configuration, its stand-in
    reference, two traffic files, two limits files and the BENCHMARK.json
    entries: new files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    bench_dir = root / "port_bench"
    (bench_dir / "configs" / "targcn_tiny.json").write_text(json.dumps(TARGCN_TINY))
    (bench_dir / "reference" / "targcn_standin.py").write_text(STAND_IN)
    serve = json.loads((bench_dir / "traffic" / "serve_b128.json").read_text())
    train = json.loads((bench_dir / "traffic" / "train_b1024.json").read_text())
    (bench_dir / "traffic" / "serve_b4.json").write_text(
        json.dumps(dict(serve, batch=4, pool_batches=2)))
    (bench_dir / "traffic" / "train_b8.json").write_text(
        json.dumps(dict(train, windows=160, batch_size=8)))
    limits = json.loads((bench_dir / "limits" / "gstcan3-train-b1024.json").read_text())
    (bench_dir / "limits" / "targcn-serve-b4.json").write_text(
        json.dumps({"logit_gap": {"limit": 1e-4}}))
    (bench_dir / "limits" / "targcn-train-b8.json").write_text(json.dumps(limits))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "targcn_tiny", "source": "https://github.com/musaru/Fall_Multimodal",
                             "file": "port_bench/configs/targcn_tiny.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"] += CELLS
    reported = {"targcn-serve-b4": ("serve_windows_per_s", "mfu.serve", "idle_share.serve"),
                "targcn-train-b8": ("train_windows_per_s", "mfu.train", "idle_share.train")}
    for entry in bench["end_to_end"] + bench["per_layer"]:
        for cell, names in reported.items():
            if entry["name"] in names:
                entry["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def harness_files():
    return sorted(os.path.relpath(os.path.join(d, f), HERE)
                  for d, dirs, fs in os.walk(HERE) for f in fs
                  if "__pycache__" not in d and not os.path.relpath(d, HERE).startswith("runs"))


def test_a_targcn_configuration_is_added_by_files_alone(tmp_path):
    root = targcn_checkout(tmp_path)
    bench_dir = os.path.join(root, "port_bench")
    serve = run.execute("targcn-serve-b4", 2 ** 31 + 11, 0.3, False, device="cpu", root=root)
    assert serve["correct"], serve["checks"]
    assert set(serve["metrics"]) == {"serve_windows_per_s", "setup_s"}
    assert serve["attempted"] % 4 == 0 and serve["failed"] == 0
    train = run.execute("targcn-train-b8", 2 ** 31 + 11, 1.0, False, device="cpu", root=root)
    assert train["correct"], train["checks"]
    assert set(train["metrics"]) == {"train_windows_per_s", "setup_s"}
    assert train["checks"]["stats_gap"]["value"] == 0.0
    # the whole-step share reads the stand-in's count through the existing metric
    cell = core.load_cell(root, "targcn-serve-b4", True)
    assert costs.forward_flops(cell.config["model"], *costs.adjacency_counts()) == 1.0e6

    class Traced:
        window_s = 2.0

    reading = cell.readers["mfu.serve"].read(core.Run(
        cell, "NVIDIA H100 80GB HBM3", 1.0, {"traced_windows": 990}, Traced(), {},
        costs.peaks("NVIDIA H100 80GB HBM3")))
    assert reading == pytest.approx(100.0 * 1.0e6 * 990 / (2.0 * 495e12))
    for path in harness_files():
        with open(os.path.join(HERE, path), "rb") as a, open(os.path.join(bench_dir, path),
                                                             "rb") as b:
            assert a.read() == b.read(), path


def test_the_targcn_stand_in_draws_no_degenerate_model():
    """Without its hook the stand-in's pools and embeddings stay at the
    constructor's zeros, which seed_weights refuses."""
    standin = {}
    exec(compile(STAND_IN, "targcn_standin.py", "exec"), standin)
    model = standin["build"](TARGCN_TINY["model"])
    with pytest.raises(ValueError, match="node_embeddings|weights_pool|bias_pool"):
        seed_weights(model, SEED, "init")
    sd = seed_weights(model, SEED, "init",
                      reference=types.SimpleNamespace(raw_leaves=standin["raw_leaves"]))
    for name, tensor in sd.items():
        if name.endswith(("weights_pool", "bias_pool", "node_embeddings")):
            assert tensor.abs().max() > 0 and np.isfinite(tensor.numpy()).all()
