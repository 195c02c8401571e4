"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fall_multimodal_tpu_torch")


def _port_files():
    for dirpath, _, names in os.walk(PORT):
        for name in names:
            if name.endswith((".py", ".cu", ".cuh", ".yaml")):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_the_port_loads_no_jax():
    code = r"""
import pkgutil, sys, importlib
import fall_multimodal_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n in ("jax", "flax", "jaxlib") or n.startswith(("jax.", "flax.", "jaxlib."))
             or n == "fall_multimodal_tpu" or n.startswith("fall_multimodal_tpu."))
print("LOADED", len([n for n in sys.modules if n.startswith("fall_multimodal_tpu_torch")]))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("LOADED")[1].split()[0]) >= 15


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_name_no_jax_module(path):
    with open(path) as fh:
        text = fh.read()
    assert not re.search(r"\bfall_multimodal_tpu\.", text)
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|jaxlib)\b", text, re.M)


def test_predictor_without_device_needs_a_card(monkeypatch):
    import torch

    from fall_multimodal_tpu_torch.configs import load_config, preset_path
    from fall_multimodal_tpu_torch.serve import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(load_config(preset_path("gstcan_urfall_3stream")), {})
