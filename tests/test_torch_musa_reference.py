"""The port's Gen-3 DropGraph model (``models/musa.py``) against the
benchmark's plain reference (``port_bench/reference/musa.py``, written from
the published model in its ``(N, C, T, V)`` layout), on the CPU at a small
width: the same state_dict names and shapes; the same eval logits under
seeded weights; one train step from generators in the same state with the
same loss, gradients and running statistics on the position and the motion
stream (the same DropGraph masks and head dropout drawn on both sides),
which a reference with DropGraph off or drawing from another seed misses
by far; the six ``edge`` masks through ``raw_leaves``; the FLOP count
against torch's counter on the port's model.

Tolerances. Both sides compute one float32 function; the eval logits read
at most 1.1e-6 of the largest logit here. A train step reads further: the
port's BatchNorm takes its batch statistics through ``F.batch_norm``,
whose float32 variance on the CPU loses digits where a channel's mean is
hundreds of times its spread (a kernel-1 depthwise conv with a small
weight before a BatchNorm), the more so on one thread, where the
reference's two-pass variance does not. On one thread, over 12 seeds
(embed 8, batch 8), the port read against the reference at most 2.17e-5 in
the loss, 0.050 in the worst leaf's gradient norm (the benchmark's
``grad_gap``) and 4.0e-5 in the running statistics, while the reference
in float32 read within 8.3e-4 of its float64 self; a reference with
DropGraph off or another seed read from 3.6e-4, 0.85 and 2.6e-3. The
limits lie between, near the middle of each pair on a log scale. The
tests run on one thread, so that the readings do not move with the
number of threads a test process gets.
"""

import ast
import inspect
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fall_multimodal_tpu_torch.configs import load_config, preset_path
from fall_multimodal_tpu_torch.models.registry import build_model
from port_bench.harness import checks, data
from port_bench.harness.weights import seed_weights
from port_bench.reference import musa as reference

SEED = 2 ** 31 + 21
BATCH = 8
LOSS_TOL = 8e-5
GRAD_TOL = 0.2
STATS_TOL = 3e-4
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def model_section(embed_dim=8, **kwargs):
    return {"num_joints": 14, "seq_len": 30, "in_channels": 3, "num_classes": 11,
            "train_seed": 42, "kwargs": {"embed_dim": embed_dim, **kwargs}}


def port_model(embed_dim=8):
    cfg = load_config(preset_path("musa_harup"),
                      overrides={"model.kwargs.embed_dim": embed_dim})
    return build_model(cfg)


def windows(seed, n=BATCH):
    w = data.make_windows(n, 30, 14, 11, 0, 0.45, seed)
    return torch.from_numpy(w.pose), torch.from_numpy(w.labels)


def seeded_pair(seed, embed_dim=8, scheme="init"):
    """The reference and the port holding one seeded state."""
    ref = reference.build(model_section(embed_dim))
    x, _ = windows(seed)
    state = seed_weights(ref, SEED + seed, scheme, condition=(x, None), reference=reference)
    port = port_model(embed_dim)
    port.load_state_dict(state)
    return ref, port, state


def train_step(model, x, y, generator=None):
    """Loss, every leaf's gradient and the running statistics of one
    train-mode forward and backward; ``generator`` for the port."""
    model.train()
    out = model(x, None, generator=generator) if generator is not None else model(x)
    loss = -(y * torch.log_softmax(out, -1)).sum(-1).mean()
    loss.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().double()
             for k, p in model.named_parameters()}
    stats = {k: v.double() for k, v in model.state_dict().items() if "running" in k}
    return float(loss.detach()), grads, stats


def norms(grads):
    return {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}


def gaps(program, ref, prefix=""):
    """(loss, grad_gap, stats_gap) of the benchmark's checks over the leaves
    whose name starts with ``prefix``."""
    pick = lambda d: {k: v for k, v in d.items() if k.startswith(prefix)}  # noqa: E731
    return (checks.relative_gap([program[0]], [ref[0]]),
            checks.norm_gap(norms(pick(program[1])), norms(pick(ref[1])))[0],
            checks.value_gap(pick(program[2]), pick(ref[2]))[0])


def test_the_reference_has_the_ports_state_dict_names_and_shapes():
    ref = reference.build(model_section(64))
    port = port_model(64)
    assert {k: v.shape for k, v in ref.state_dict().items()} == \
        {k: v.shape for k, v in port.state_dict().items()}
    assert sum(p.numel() for p in ref.parameters()) == 427_107
    for name, buf in ref.state_dict().items():
        if name.endswith(".A"):
            torch.testing.assert_close(buf, port.state_dict()[name], rtol=0, atol=1e-7)


@pytest.mark.parametrize("embed_dim", [8, 64])
def test_the_eval_forward_equals_the_ports(embed_dim):
    _, port, state = seeded_pair(3, embed_dim, "trained")
    ref = reference.build(model_section(embed_dim))
    ref.load_state_dict(state)
    x, _ = windows(4, 4)
    with torch.no_grad():
        gap = checks.logit_gap(port.eval()(x).double().numpy(), ref.eval()(x).double().numpy())
    assert gap <= LOGIT_TOL
    assert ref.generator is None                      # the eval forward draws nothing


@pytest.mark.parametrize("stream", ["stream_pos", "stream_mot"])
def test_one_train_step_gives_the_references_loss_gradients_and_statistics(stream):
    for seed in range(4):
        ref, port, _ = seeded_pair(seed)
        x, y = windows(seed)
        program = train_step(port, x, y, torch.Generator().manual_seed(42))
        loss, grad, stats = gaps(program, train_step(ref, x, y), stream)
        assert loss <= LOSS_TOL and grad <= GRAD_TOL and stats <= STATS_TOL, (seed, loss, grad,
                                                                                stats)
        leaves = [k for k in program[1] if k.startswith(stream)]
        assert len(leaves) == 49 and any(program[1][k].abs().max() > 0 for k in leaves
                                         if k.endswith(".0.edge"))


@pytest.mark.parametrize("fault", ["dropgraph_off", "another_seed"])
def test_a_reference_that_draws_otherwise_reads_far_outside_the_tolerance(fault):
    _, port, state = seeded_pair(5)
    x, y = windows(5)
    section = model_section(keep_prob=1.0, dropout=0.0) if fault == "dropgraph_off" else \
        dict(model_section(), train_seed=43)
    ref = reference.build(section)
    ref.load_state_dict(state)
    loss, grad, stats = gaps(train_step(port, x, y, torch.Generator().manual_seed(42)),
                             train_step(ref, x, y))
    assert loss > LOSS_TOL and grad > 4 * GRAD_TOL and stats > 8 * STATS_TOL, (loss, grad, stats)


def test_a_float64_reference_draws_the_float32_references_masks():
    """The probabilities are cast to float32 before each draw, so the
    benchmark's float64 witness draws what the float32 reference draws."""
    ref32, _, state = seeded_pair(6)
    ref64 = reference.build(model_section()).double()
    ref64.load_state_dict(state)
    x, _ = windows(6)
    gap = checks.logit_gap(ref32.train()(x).detach().double().numpy(),
                           ref64.train()(x.double()).detach().numpy())
    assert gap <= LOGIT_TOL
    other = reference.build(dict(model_section(), train_seed=43)).double()
    other.load_state_dict(state)
    assert checks.logit_gap(other.train()(x.double()).detach().numpy(),
                            ref64.train()(x.double()).detach().numpy()) > 100 * LOGIT_TOL


def test_a_train_forward_draws_from_one_generator_made_at_the_first_train_forward():
    ref, _, _ = seeded_pair(7)
    x, _ = windows(7)
    assert ref.generator is None
    ref.train()(x)
    first = ref.generator.get_state().clone()
    fresh = torch.Generator().manual_seed(42)
    assert not torch.equal(first, fresh.get_state())       # it drew
    ref.train()(x)
    assert not torch.equal(first, ref.generator.get_state())
    ref.eval()(x)                                            # eval leaves it as it was
    after = ref.generator.get_state().clone()
    ref.eval()(x)
    assert torch.equal(after, ref.generator.get_state())


@pytest.mark.parametrize("scheme", ["init", "trained"])
def test_raw_leaves_yields_the_six_edge_masks(scheme):
    ref = reference.build(model_section(64))
    names = {id(p): n for n, p in ref.named_parameters()}
    got = [(names[id(t)], scale, offset) for t, scale, offset in reference.raw_leaves(ref, scheme)]
    assert sorted(n for n, _, _ in got) == sorted(
        f"{s}.{i}.edge" for s in ("stream_pos", "stream_mot") for i in range(3))
    assert {(scale, offset) for _, scale, offset in got} == {
        (0.0 if scheme == "init" else 0.2, 1.0)}
    x, _ = windows(8, 2)
    state = seed_weights(ref, SEED, scheme, condition=(x, None), reference=reference)
    edges = [state[n] for n, _, _ in got]
    assert all(e.shape == (1, 14, 14) for e in edges)
    if scheme == "init":
        assert all(bool((e == 1).all()) for e in edges)
    else:
        assert all(0.8 <= float(e.min()) and float(e.max()) <= 1.2 and float(e.std()) > 0.05
                   for e in edges)


@pytest.mark.parametrize("model", ["reference", "port"])
def test_seed_weights_refuses_the_model_without_the_edge_masks(model):
    m = reference.build(model_section()) if model == "reference" else port_model()
    for scheme in ("init", "trained"):
        with pytest.raises(ValueError, match="edge"):
            seed_weights(m, SEED, scheme, condition=(windows(9, 2)[0], None))
        with pytest.raises(ValueError, match="edge"):
            seed_weights(m, SEED, scheme, condition=(windows(9, 2)[0], None),
                         reference=types.SimpleNamespace())


@pytest.mark.parametrize("embed_dim", [8, 64])
def test_forward_flops_is_torchs_count_of_the_ports_forward(embed_dim):
    """Dense adjacency: the port's einsum over the whole 14 x 14 matrix is
    what ``FlopCounterMode`` counts, and what ``forward_flops`` states."""
    port = port_model(embed_dim).eval()
    x = torch.rand(3, 30, 14, 3, generator=torch.Generator().manual_seed(embed_dim))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        port(x)
    assert reference.forward_flops(model_section(embed_dim)) == counter.get_total_flops() / 3
    if embed_dim == 64:
        assert reference.forward_flops(model_section(64)) == 176_130_560


def test_the_reference_imports_neither_package_nor_jax():
    tree = ast.parse(inspect.getsource(reference))
    imported = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                for alias in node.names}
    imported |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert imported <= {"__future__", "typing", "torch", "torch.nn", "torch.nn.functional",
                        "port_bench.reference.stgcan"}
    assert not {m.split(".")[0] for m in imported} & {"jax", "jaxlib", "flax", "numpy",
                                                       "fall_multimodal_tpu",
                                                       "fall_multimodal_tpu_torch"}
