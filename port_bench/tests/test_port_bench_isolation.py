"""The benchmark imports neither JAX nor the JAX package, and its plain
references import nothing of the system under test: every ``.py`` under
``port_bench/`` is parsed and each imported module's top-level name (the
part before the first dot) is compared whole."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "fall_multimodal_tpu"}
SYSTEM = "fall_multimodal_tpu_torch"


def _sources():
    for dirpath, _, names in os.walk(HERE):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted(p for p in _sources()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_references_import_nothing_of_the_system(path):
    assert SYSTEM not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "typing", "numpy", "torch", "port_bench"}


def test_the_rule_compares_whole_names(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import fall_multimodal_tpu_torch.serve\nfrom jaxtyping import A\n"
                   "import fall_multimodal_tpu.ops\n")
    assert top_level_imports(str(src)) == {"fall_multimodal_tpu_torch", "jaxtyping",
                                           "fall_multimodal_tpu"}
    assert top_level_imports(str(src)) & BANNED == {"fall_multimodal_tpu"}
