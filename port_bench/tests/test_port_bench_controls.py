"""On the card (marker ``cuda``): at each cell's own size, on three seeds,
the control (the plain reference computed in TF32, in the system's place)
fails the cell's limits, and the system passes them. Run on the card with

    python -m pytest -p no:cacheprovider -m cuda port_bench/tests/test_port_bench_controls.py"""

import os

import pytest
import torch

from port_bench import calibrate
from port_bench.harness import core
from port_bench.harness.trace import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["gstcan3-serve-b128", "stgcan-serve-b128", "gstcan3-train-b1024"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the system's kernels have no CPU mode")
    return torch.device("cuda")


def numbers(reading):
    """``{number: value}`` of one side's reading (a serving cell's is one gap)."""
    if isinstance(reading, dict):
        return {k: v for k, v in reading.items() if k != "readings"}
    return {"logit_gap": reading}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_system_passes(card, cell):
    spec = core.load_cell(ROOT, cell, False)
    limits = {k: v["limit"] for k, v in spec.limits.items()}
    for seed in (9001, 9002, 9003):
        ctx = core.Ctx(spec, seed, 3.0, card, Tracer(False, ""), 0.0)
        row = calibrate.READINGS[spec.traffic["generator"]](ctx)
        program, control = numbers(row["program"]), numbers(row["control"])
        assert all(program[k] <= limits[k] for k in limits), (seed, program, limits)
        assert any(control[k] > limits[k] for k in limits), (seed, control, limits)
