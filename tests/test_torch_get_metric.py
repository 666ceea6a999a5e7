"""The port's ``cli.get_metric`` against ``sige_tpu``'s, on the CPU: both
``main``s on the same directories (three non-square image pairs written
by the port's PNG codec, masks, raw Cityscapes label maps) and the same
synthetic checkpoints in the published files' layouts
(``chip_smoke.metric_weights``: torchvision ``alexnet`` and
``inception_v3``, lpips ``alex.pth``, the DataParallel DRN-D-105):

  * the PSNR line (with ``--mask_root``) and the mIoU line over ``.npy``
    predictions are identical;
  * LPIPS and mIoU through ``--drn_weights`` agree within 1e-4, and FID
    within 1e-3 relative: with fewer images than 2048 features the
    covariances are singular, and ``_sqrtm_psd``'s square roots of
    eigenvalues near 0 magnify float32 differences of 1e-6;
  * without a GPU the CLI raises unless it is given ``--device cpu``.
"""

import re
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from sige_torch.cli import get_metric
from sige_torch.data import save_image
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("metric")
    d = {name: tmp / name for name in ("results", "gt", "masks", "seg",
                                       "seg_gt", "labels")}
    for p in d.values():
        p.mkdir()
    rng = np.random.default_rng(0)
    H, W = 40, 56
    for i in range(3):
        img = rng.random((H, W, 3)).astype(np.float32)
        save_image(str(d["results"] / f"im{i}.png"), img)
        save_image(str(d["gt"] / f"im{i}.png"),
                   np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1))
        m = np.zeros((H, W), bool)
        m[4:20, 8:40] = True
        np.save(d["masks"] / f"im{i}.npy", m)
        np.save(d["seg"] / f"seg{i}.npy", rng.integers(0, 34, (H, W)))
        np.save(d["seg_gt"] / f"seg{i}.npy", rng.integers(0, 34, (H, W)))
        # raw label maps for the segmented results (--drn_weights)
        np.save(d["labels"] / f"im{i}.npy", rng.integers(0, 34, (H, W)))
    d.update(chip_smoke.metric_weights(str(tmp), seed=0))
    return d


def _line(out, name):
    m = re.search(rf"^{name}: .*$", out, re.M)
    assert m, out
    return m.group(0)


def _value(line):
    return float(line.split(":")[1].split()[0])


def _both(argv, capsys, monkeypatch):
    """(the port's line, its returned value, sige_tpu's line)."""
    from sige_tpu.cli import get_metric as jget_metric

    name = {"psnr": "PSNR", "lpips": "LPIPS", "fid": "FID",
            "miou": "mIoU"}[argv[argv.index("--metric") + 1]]
    value = get_metric.main(argv + ["--device", "cpu"])
    ours = _line(capsys.readouterr().out, name)
    monkeypatch.setattr(sys, "argv", ["get_metric", *argv])
    jget_metric.main()
    return ours, value, _line(capsys.readouterr().out, name)


def _args(dirs, metric, root="results", gt="gt", **flags):
    argv = ["--metric", metric, "--root", str(dirs[root]),
            "--gt_root", str(dirs[gt])]
    for flag, key in flags.items():
        argv += [f"--{flag}", str(dirs[key])]
    return argv


def test_psnr_and_miou_lines_identical(dirs, capsys, monkeypatch):
    ours, value, theirs = _both(
        _args(dirs, "psnr", mask_root="masks"), capsys, monkeypatch)
    assert ours == theirs and "over 3 images" in ours
    assert np.isfinite(value)
    ours, _, theirs = _both(_args(dirs, "miou", "seg", "seg_gt"), capsys,
                            monkeypatch)
    assert ours == theirs and "over 3 maps" in ours


def test_lpips_agrees(dirs, capsys, monkeypatch):
    ours, value, theirs = _both(_args(
        dirs, "lpips", mask_root="masks", backbone_weights="backbone_weights",
        lpips_weights="lpips_weights"), capsys, monkeypatch)
    assert value > 0 and "over 3 images" in ours
    assert abs(_value(ours) - _value(theirs)) <= 1e-4 + 1e-12


def test_fid_agrees(dirs, capsys, monkeypatch):
    ours, value, theirs = _both(_args(
        dirs, "fid", inception_weights="inception_weights"), capsys,
        monkeypatch)
    assert np.isfinite(value) and value > 0
    assert _value(ours) == pytest.approx(_value(theirs), rel=1e-3)


def test_miou_through_drn_agrees(dirs, capsys, monkeypatch):
    ours, value, theirs = _both(_args(
        dirs, "miou", gt="labels", mask_root="masks",
        drn_weights="drn_weights"), capsys,
        monkeypatch)
    assert "over 3 maps" in ours and "over 3 maps" in theirs
    assert 0 <= value <= 1
    assert abs(_value(ours) - _value(theirs)) <= 1e-4 + 1e-12


def test_needs_device_cpu_without_a_gpu(dirs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_metric.main(_args(dirs, "lpips"))
