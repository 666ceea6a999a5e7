"""The port's native host planner (``sige_torch/native``) against its
numpy paths and against sige_tpu's core functions.

  * every product of the core functions (dilation, the padded tile
    reduction, the source maps, the fused scatter-gather lookups) is the
    same array, dtype and shape with the library and without it
    (``SIGE_TPU_NO_NATIVE=1``), bit for bit, on ``tests/test_native.py``'s
    geometries and seeds and on the empty and the full mask, and equals
    sige_tpu's (its numpy paths: its own build is left alone here);
  * ``build_plan`` through ``SIGEModel.plan_masks`` gives the same plan
    key by key with and without the library on the tiny DDPM, in tiles,
    window and ``auto``;
  * six processes building at once into an empty directory each load a
    whole library, agree, and leave one file and no partial one;
  * ``SIGE_TPU_NO_NATIVE=1`` turns the library off; without ``g++`` the
    numpy paths run and a warning says so once; a source that does not
    compile raises with the compiler's log.
"""

import hashlib
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import sige_tpu.native as jnative
from sige_tpu.core import masks as jm
from sige_tpu.core import scatter_map as jsm
from sige_tpu.core.geometry import BlockGeometry as JGeom
from sige_torch import native
from sige_torch.core import masks as m
from sige_torch.core import scatter_map as sm
from sige_torch.core.geometry import BlockGeometry
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel

ROOT = Path(__file__).resolve().parents[1]
GEOMS = [(6, 3, 1, 1), (4, 1, 1, 0), (6, 3, 2, 1)]  # tests/test_native.py
H, W = 37, 41


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("the native planner builds with g++, which this host "
                    "lacks")
    assert native.available()
    return native


def _mask(kind):
    if kind == "empty":
        return np.zeros((H, W), bool)
    if kind == "full":
        return np.ones((H, W), bool)
    return np.random.default_rng(int(kind[-1])).random((H, W)) < 0.07


def _products(core_masks, core_maps, geom, mask):
    """Every array the core functions give for ``mask``: dilations, the
    tile reduction at its own bucket and at a pinned capacity, the source
    maps of live rows and of all rows, and the fused lookups."""
    out = {"dilate_2": core_masks.dilate_mask(mask, 2),
           "dilate_1x3": core_masks.dilate_mask(mask, (1, 3))}
    idx, n = core_masks.reduce_mask_padded(mask, geom)
    total = core_masks.grid_tiles(mask.shape, geom)
    idx_pin, n_pin = core_masks.reduce_mask_padded(mask, geom,
                                                   capacity=total)
    out.update(indices=idx, count=np.int64(n), indices_pinned=idx_pin,
               count_pinned=np.int64(n_pin))
    for hw in ((H, W), (H // 2 + 1, W // 2 + 1)):
        key = f"{hw[0]}x{hw[1]}"
        out[f"src_{key}"] = core_maps.build_src_map(idx, n, geom, hw)
        out[f"src_all_{key}"] = core_maps.build_src_map(
            idx_pin[:max(n_pin, 1)], None, geom, hw)
        out[f"sgsrc_{key}"], out[f"sgflat_{key}"] = \
            core_maps.build_sg_sources(idx, n, geom, hw)
    out["pixsrc"] = core_maps.build_src_map(
        idx, n, core_maps.gather_position_geom(geom), (H, W))
    return out


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("kind", ["seed0", "seed1", "empty", "full"])
@pytest.mark.parametrize("geom_args", GEOMS)
def test_native_equals_numpy_and_sige_tpu(built, monkeypatch, geom_args,
                                          kind):
    mask = _mask(kind)
    geom = BlockGeometry.create(*geom_args)
    calls = []
    for name in ("dilate_mask", "count_tiles", "build_src_map",
                 "build_sg_sources"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _f=real, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    got = _products(m, sm, geom, mask)
    assert set(calls) == {"dilate_mask", "count_tiles", "build_src_map",
                          "build_sg_sources"}

    monkeypatch.setenv("SIGE_TPU_NO_NATIVE", "1")
    calls.clear()
    want = _products(m, sm, geom, mask)
    assert not calls
    _assert_same(got, want, "native vs numpy")

    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    ref = _products(jm, jsm, JGeom.create(*geom_args), mask)
    _assert_same(got, ref, "port vs sige_tpu")


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.mark.parametrize("layout", ["tiles", "window", "auto"])
def test_build_plan_native_equals_numpy(built, monkeypatch, layout):
    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32,
                         sparse_resolution_threshold=32)
    model = SIGEModel(SIGEFusedUNet(cfg), bucket_min=1, layout=layout,
                      device="cpu")
    model.init(0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(
        np.float32))
    model.full(x, torch.zeros((1,)))
    mask = np.zeros((32, 32), bool)
    mask[8:16, 10:20] = True
    mask[24:28, 2:6] = True
    masks = m.downsample_mask(m.dilate_mask(mask, 2), min_res=4)
    plan, got_layout = model.plan_masks(masks)
    monkeypatch.setenv("SIGE_TPU_NO_NATIVE", "1")
    want, want_layout = model.plan_masks(masks)
    assert got_layout == want_layout
    if layout != "tiles":
        assert got_layout == "window"
    got_leaves, want_leaves = dict(_walk(plan)), dict(_walk(want))
    assert got_leaves.keys() == want_leaves.keys()
    _assert_same(got_leaves, want_leaves, f"plan in {layout}")


_BUILD_AND_USE = """
import hashlib, sys
import numpy as np
from sige_torch.native import Planner
p = Planner(build_dir=sys.argv[1])
lib = p.load()
mask = (np.random.default_rng(0).random((37, 41)) < 0.1).astype(np.uint8)
out = np.empty_like(mask)
lib.dilate_mask(mask, out, 37, 41, 2, 3)
print(p.path, hashlib.sha256(out.tobytes()).hexdigest())
"""


def test_concurrent_builds_each_load_a_whole_library(built, tmp_path):
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_USE,
                               str(build_dir)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1, outs
    files = sorted(p.name for p in build_dir.iterdir())
    assert files == [Path(outs[0].split()[0]).name]
    mask = (np.random.default_rng(0).random((37, 41)) < 0.1)
    want = m.dilate_mask(mask, (2, 3)).astype(np.uint8)
    assert outs[0].split()[1] == hashlib.sha256(want.tobytes()).hexdigest()


def test_no_native_env_turns_the_library_off(built, monkeypatch):
    monkeypatch.setenv("SIGE_TPU_NO_NATIVE", "1")
    assert not native.available()

    def refuse(*a, **k):
        raise AssertionError("the native path ran")

    monkeypatch.setattr(native, "dilate_mask", refuse)
    mask = _mask("seed0")
    assert m.dilate_mask(mask, 1).sum() > mask.sum()
    monkeypatch.delenv("SIGE_TPU_NO_NATIVE")
    assert native.available()


def test_no_compiler_warns_once_and_uses_numpy(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    planner = native.Planner(build_dir=tmp_path / "build")
    monkeypatch.setattr(native, "PLANNER", planner)
    mask = _mask("seed1")
    with pytest.warns(RuntimeWarning, match="no g\\+\\+ on PATH"):
        assert not native.available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.available()
        got = m.dilate_mask(mask, 2)
    monkeypatch.setenv("SIGE_TPU_NO_NATIVE", "1")
    np.testing.assert_array_equal(got, m.dilate_mask(mask, 2))
    assert not (tmp_path / "build").exists()


def test_source_that_does_not_compile_raises(built, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text('extern "C" void dilate_mask( {\n')
    planner = native.Planner(source=bad, build_dir=tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        planner.load()
    assert "error" in str(err.value)
    assert planner.lib is None
    assert list((tmp_path / "build").iterdir()) == []
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        planner.load()  # never gives way to numpy quietly
