"""sige_torch, and the scripts and tests that run on the machine with the
card (which has no JAX), import nothing of JAX, flax or sige_tpu."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sige_tpu")


def _sources():
    return sorted((ROOT / "sige_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "trace_torch_step.py",
        ROOT / "tests" / "test_torch_gpu.py"]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import sige_torch, sige_torch.runners, sige_torch.utils.from_jax\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
