"""No JAX: the run's check of loaded modules compares top-level names
whole, and the benchmark's sources import neither JAX nor the JAX
package; the reference imports nothing of the program."""

import ast
from pathlib import Path

from sigebench.harness import forbidden_modules

PKG = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    loaded = ["sige_torch", "sige_torch.ops.flash", "sige_tpux", "jaxtyping",
              "flaxen", "numpy", "torch.nn"]
    assert forbidden_modules(loaded) == []
    assert forbidden_modules(loaded + ["sige_tpu.nn.engine"]) == ["sige_tpu"]
    assert forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in PKG.rglob("*.py"):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax",
                                          "sige_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        assert "sige_torch" not in set(_imports(path)), path
