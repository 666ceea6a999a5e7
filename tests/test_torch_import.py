"""sige_torch, and the scripts and tests that run on the machine with the
card (which has no JAX, no PIL, no PyYAML and no transformers), import
nothing of JAX, flax, sige_tpu, PIL, yaml, transformers, ftfy or regex."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the machine with the card has no imaging library either (the port
# carries its own PNG codec), no PyYAML (the port reads its configs) and
# no transformers, ftfy or regex (the port has its own CLIP tokenizer)
FORBIDDEN = ("jax", "jaxlib", "flax", "sige_tpu", "PIL", "yaml",
             "transformers", "ftfy", "regex")


def _sources():
    return sorted((ROOT / "sige_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "trace_torch_step.py",
        ROOT / "scripts" / "retime_cost.py",
        ROOT / "tests" / "torch_png_writer.py",
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


def test_demo_server_and_serving_pull_in_no_jax_and_no_pil():
    code = (
        "import sys\n"
        "import sige_torch.demo.server, sige_torch.parallel.serving\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_command_lines_and_checkpoints_pull_in_nothing_forbidden():
    code = (
        "import sys\n"
        "import sige_torch.cli.diffusion, sige_torch.cli.gaugan, "
        "sige_torch.cli.sd, sige_torch.data, sige_torch.utils.config, "
        "sige_torch.utils.convert, sige_torch.utils.convert_sd, "
        "sige_torch.utils.checkpoint, sige_torch.utils.ema, "
        "sige_torch.utils.watermark, sige_torch.utils.html\n"
        "from sige_torch.utils.config import load_config\n"
        "load_config('configs/sd-sige.yaml')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_text_path_pulls_in_nothing_forbidden():
    code = (
        "import sys\n"
        "import sige_torch.models.sd.clip, sige_torch.models.sd.safety, "
        "sige_torch.models.sd.tokenizer\n"
        "from sige_torch.models.sd.tokenizer import clean_text, split_words\n"
        "assert split_words(clean_text(\"It's 42\")) == "
        "[\"it\", \"'s\", \"4\", \"2\"]\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_quality_path_pulls_in_nothing_forbidden():
    code = (
        "import sys\n"
        "import sige_torch.metrics, sige_torch.metrics.backbones, "
        "sige_torch.cli.get_metric, sige_torch.cli.golden, "
        "sige_torch.utils.registry\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_native_planner_twin_server_and_colorize_pull_in_nothing_forbidden():
    code = (
        "import sys\n"
        "import sige_torch.native, sige_torch.parallel, "
        "sige_torch.runners.common, sige_torch.utils.colorize\n"
        "from sige_torch.parallel import TwinStepServer\n"
        "sige_torch.native.available()\n"
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


@pytest.mark.parametrize("phase", ["checkpoints", "sd_text",
                                   "engine_options", "quality", "twin",
                                   "sessions", "flash"])
def test_chip_smoke_phase_exits_without_a_card(phase, monkeypatch, capsys):
    """``chip_smoke.py --phase <phase>`` selects one phase, and like the
    whole run exits non-zero, having run nothing, where there is no CUDA
    device."""
    import torch

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(["--phase", phase]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
