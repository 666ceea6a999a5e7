"""The port's checkpoint registry and golden pipeline
(``sige_torch.utils.registry``, ``sige_torch.cli.golden``) on the CPU:

  * the registry: ``fetch`` resolves a local file and verifies its md5;
    a mismatch raises naming the mirror's URL; a missing file without
    ``SIGE_TPU_ALLOW_DOWNLOAD`` raises without opening any URL;
    ``download`` over ``file://`` writes through a ``.part`` file (a stale
    one is not resumed on a non-http scheme); the names, md5s and URLs
    are ``sige_tpu``'s, and every spec's converter resolves to a callable
    of ``sige_torch``;
  * golden dry runs at tiny widths over ``file://`` mirrors of synthetic
    reference checkpoints (``tests/test_torch_cli.py``'s writers): DDPM
    (fetch, md5, convert, generate over the SDEdit layout, PSNR, LPIPS and
    FID with ``chip_smoke.metric_weights``' backbones), GauGAN (over a
    cityscapes-edit layout, mIoU through the DRN and FID) and SD
    (``tests/test_golden_pipeline.py``'s tiny hparams, its three
    examples, ``--embeddings``). Each run writes its files, prints the
    scored list, and its metric lines equal the port's ``get_metric``
    run on the same directories.

Only ``file://`` URLs are ever opened.
"""

import csv
import hashlib
import importlib
import os
import pathlib
import re
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from sige_torch.cli import get_metric, golden
from sige_torch.data import save_image
from sige_torch.utils import registry as reg
from test_golden_pipeline import TINY_SD_UNET_HP
from test_torch_cli import (DDPM_TINY_HPARAMS, GAUGAN_TINY,
                            _gaugan_reference, _write_reference)
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _md5(path):
    return hashlib.md5(pathlib.Path(path).read_bytes()).hexdigest()


def _mirror(monkeypatch, name, path, md5="auto"):
    """Point the registry's ``name`` at ``path`` over ``file://`` with its
    md5 (or ``md5``)."""
    spec = reg.REGISTRY[name]
    url = pathlib.Path(path).as_uri()
    monkeypatch.setitem(reg.REGISTRY, name, reg.CheckpointSpec(
        spec.name, _md5(path) if md5 == "auto" else md5, url,
        spec.converter))
    return url


@pytest.fixture
def no_network(monkeypatch):
    """Any URL but ``file://`` fails the test."""
    opened = []
    real = urllib.request.urlopen

    def urlopen(req, *a, **kw):
        url = req.full_url if isinstance(req, urllib.request.Request) else req
        opened.append(url)
        if not url.startswith("file://"):
            raise AssertionError(f"opened {url}")
        return real(req, *a, **kw)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return opened


# --- the registry ---------------------------------------------------------------

def test_registry_matches_sige_tpu_and_converters_resolve():
    from sige_tpu.utils import registry as jreg

    assert reg.REGISTRY.keys() == jreg.REGISTRY.keys()
    for name, spec in reg.REGISTRY.items():
        theirs = jreg.REGISTRY[name]
        assert (spec.name, spec.md5, spec.url) == (
            theirs.name, theirs.md5, theirs.url)
        assert spec.converter.startswith("sige_torch.utils.")
        module, attr = spec.converter.rsplit(".", 1)
        assert callable(getattr(importlib.import_module(module), attr))


def test_fetch_local_file_and_md5(tmp_path, monkeypatch, no_network):
    name = "spade.pth"
    root = tmp_path / "pretrained"
    root.mkdir()
    path = root / name
    path.write_bytes(b"weights")
    monkeypatch.delenv("SIGE_TPU_ALLOW_DOWNLOAD", raising=False)
    url = _mirror(monkeypatch, name, path)
    assert reg.fetch(name, root=str(root)) == str(path)
    _mirror(monkeypatch, name, path, md5="0" * 32)
    with pytest.raises(ValueError, match=re.escape(url)):
        reg.fetch(name, root=str(root))
    with pytest.raises(FileNotFoundError, match="spade.pth"):
        reg.fetch(name, root=str(tmp_path / "empty"))
    assert no_network == []
    with pytest.raises(RuntimeError, match="SIGE_TPU_ALLOW_DOWNLOAD"):
        reg.download(name, root=str(tmp_path / "dl"))


def test_download_over_file_mirror_writes_through_part(tmp_path, monkeypatch,
                                                       no_network):
    name = "fused_spade.pth"
    src = tmp_path / "mirror" / name
    src.parent.mkdir()
    src.write_bytes(os.urandom(3 << 20))
    url = _mirror(monkeypatch, name, src)
    monkeypatch.setenv("SIGE_TPU_ALLOW_DOWNLOAD", "1")
    root = tmp_path / "pretrained"
    root.mkdir()
    (root / (name + ".part")).write_bytes(b"stale")  # not resumed: file://
    renames = []
    real_replace = os.replace

    def replace(a, b):
        renames.append((a, b))
        real_replace(a, b)

    monkeypatch.setattr(reg.os, "replace", replace)
    path = reg.fetch(name, root=str(root))
    assert renames == [(path + ".part", path)]
    assert _md5(path) == _md5(src) and not os.path.exists(path + ".part")
    assert no_network == [url]
    # a corrupt local copy is fetched again when downloads are allowed
    pathlib.Path(path).write_bytes(b"corrupt")
    assert _md5(reg.fetch(name, root=str(root))) == _md5(src)


# --- golden dry runs --------------------------------------------------------------

def _lines(out, names=("PSNR", "LPIPS", "FID", "mIoU")):
    return {n: m.group(0) for n in names
            for m in [re.search(rf"^{n}: .*$", out, re.M)] if m}


def _same_as_get_metric(out, capsys, argvs):
    """Each metric line of the golden run equals the port's ``get_metric``
    on the same directories and weights."""
    got = _lines(out)
    for argv in argvs:
        get_metric.main(argv + ["--device", "cpu"])
        (name, line), = _lines(capsys.readouterr().out).items()
        assert got[name] == line


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return chip_smoke.metric_weights(str(tmp_path_factory.mktemp("weights")))


def test_golden_ddpm_dry_run(tmp_path, monkeypatch, capsys, weights,
                             no_network):
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from test_golden_pipeline import _write_dataset

    cfg = DDPMUNetConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(16,), resolution=32, num_groups=8)
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    pth, _ = _write_reference(mirror, "church256-ddpm-fused_unet", "ddpm",
                              lambda: SIGEFusedUNet(cfg))
    url = _mirror(monkeypatch, "church256-ddpm-fused_unet.pth", pth)
    monkeypatch.setenv("SIGE_TPU_ALLOW_DOWNLOAD", "1")
    data_root = tmp_path / "database"
    _write_dataset(str(data_root))
    monkeypatch.chdir(ROOT)  # config paths are repo-relative
    save_dir = tmp_path / "results"
    scored = golden.main([
        "--family", "ddpm", "--data_root", str(data_root),
        "--save_dir", str(save_dir),
        "--pretrained_root", str(tmp_path / "pretrained"),
        "--mirror", url, "--metrics", "psnr,lpips,fid",
        "--backbone_weights", weights["backbone_weights"],
        "--lpips_weights", weights["lpips_weights"],
        "--inception_weights", weights["inception_weights"],
        "--device", "cpu", "--", "--hparams", DDPM_TINY_HPARAMS])
    out = capsys.readouterr().out
    fetched = tmp_path / "pretrained" / "church256-ddpm-fused_unet.pth"
    assert _md5(fetched) == _md5(pth) and no_network == [url]
    assert sorted(os.listdir(save_dir)) == ["000.png", "001.png",
                                            "index.html"]
    assert scored == ["psnr", "lpips", "fid"]
    assert "[golden] scored: ['psnr', 'lpips', 'fid']" in out
    assert "over 2 images" in _lines(out)["PSNR"]
    base = ["--root", str(save_dir), "--gt_root", str(data_root / "gt")]
    _same_as_get_metric(out, capsys, [
        ["--metric", "psnr", *base],
        ["--metric", "lpips", *base, "--backbone_weights",
         weights["backbone_weights"], "--lpips_weights",
         weights["lpips_weights"]],
        ["--metric", "fid", *base, "--inception_weights",
         weights["inception_weights"]]])


def _write_cityscapes_edit(root, crop=128, input_nc=35):
    """The cityscapes-edit layout: meta.csv pairing gt and synthetic
    label/instance maps, and raw-id ground truth per generated name."""
    rng = np.random.default_rng(11)
    H, W = crop // 2, crop
    for sub in ("maps", "gt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    l0 = rng.integers(0, input_nc - 1, (H, W))
    l1 = l0.copy()
    l1[20:32, 40:60] = input_nc - 1
    for name, arr in (("gt_label", l0), ("synthetic_label", l1)):
        np.save(os.path.join(root, "maps", name + ".npy"), arr)
    with open(os.path.join(root, "meta.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "gt_label", "gt_instance", "synthetic_label",
                    "synthetic_instance"])
        w.writerow(["0", "maps/gt_label.npy", "maps/gt_label.npy",
                    "maps/synthetic_label.npy", "maps/synthetic_label.npy"])
    for name in ("0", "0-sym"):
        np.save(os.path.join(root, "gt", name + ".npy"),
                rng.integers(0, 34, (H, W)))


def test_golden_gaugan_dry_run(tmp_path, monkeypatch, capsys, weights,
                               no_network):
    pth, _, _ = _gaugan_reference(tmp_path, "fused")
    data_root = tmp_path / "cityscapes-edit"
    _write_cityscapes_edit(str(data_root))
    monkeypatch.delenv("SIGE_TPU_ALLOW_DOWNLOAD", raising=False)
    save_dir = tmp_path / "results"
    scored = golden.main([
        "--family", "gaugan", "--data_root", str(data_root),
        "--save_dir", str(save_dir), "--checkpoint", pth,
        "--drn_weights", weights["drn_weights"],
        "--device", "cpu", "--", *GAUGAN_TINY])
    out = capsys.readouterr().out
    assert sorted(os.listdir(save_dir)) == ["0-sym.png", "0.png",
                                            "index.html"]
    assert scored == ["miou"] and "[golden] scored: ['miou']" in out
    assert "[golden] skipping fid: no --inception_weights" in out
    assert "over 2 maps" in _lines(out)["mIoU"]
    assert no_network == []
    _same_as_get_metric(out, capsys, [[
        "--metric", "miou", "--root", str(save_dir), "--gt_root",
        str(data_root / "gt"), "--drn_weights", weights["drn_weights"]]])


def test_golden_sd_dry_run(tmp_path, monkeypatch, capsys, no_network):
    from sige_torch.cli.sd import _apply_hparams
    from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
    from sige_torch.runners import SDRunConfig

    H, W = 16, 32
    unet_cfg, vae_cfg, _ = _apply_hparams(
        TINY_SD_UNET_HP, SDUNetConfig(), SDVAEConfig(resolution=W),
        SDRunConfig())
    ckpt = tmp_path / "mirror" / "sd-v1-4.ckpt"
    ckpt.parent.mkdir()
    torch.save({"state_dict": chip_smoke.reference_values(
        chip_smoke.sd_reference_layout(unet_cfg, vae_cfg), 4,
        device="cpu")}, str(ckpt))
    url = _mirror(monkeypatch, "sd-v1-4.ckpt", ckpt, md5=None)
    monkeypatch.setenv("SIGE_TPU_ALLOW_DOWNLOAD", "1")

    # the reference's asset layout (tests/test_golden_pipeline.py)
    rng = np.random.default_rng(3)
    data_root = tmp_path / "assets"
    for sub in ("inpainting/original", "inpainting/masks", "img2img/original",
                "img2img/edited", "embeddings", "gt"):
        os.makedirs(data_root / sub, exist_ok=True)
    save_image(str(data_root / "inpainting/original/0.png"),
               rng.random((H, W, 3)).astype(np.float32))
    mask = np.zeros((H, W), bool)
    mask[4:10, 10:20] = True
    np.save(str(data_root / "inpainting/masks/0.npy"), mask)
    for i in range(2):
        a = rng.random((H, W, 3)).astype(np.float32)
        b = a.copy()
        b[5:11, 8:18] = rng.random((6, 10, 3))
        save_image(str(data_root / f"img2img/original/{i}.png"), a)
        save_image(str(data_root / f"img2img/edited/{i}.png"), b)
    for name in ("inpainting_0", "img2img_0", "img2img_1"):
        emb = 0.02 * rng.standard_normal((2, 77, 16)).astype(np.float32)
        np.savez(str(data_root / "embeddings" / (name + ".npz")),
                 uc=emb[:1], c=emb[1:])
        save_image(str(data_root / "gt" / (name + ".png")),
                   rng.random((H, W, 3)).astype(np.float32))

    monkeypatch.chdir(ROOT)
    save_dir = tmp_path / "results"
    scored = golden.main([
        "--family", "sd", "--data_root", str(data_root),
        "--save_dir", str(save_dir),
        "--pretrained_root", str(tmp_path / "pretrained"), "--mirror", url,
        "--metrics", "psnr", "--device", "cpu", "--",
        "--hparams", TINY_SD_UNET_HP, "--H", str(H), "--W", str(W),
        "--ddim_steps", "2", "--no_watermark"])
    out = capsys.readouterr().out
    assert no_network == [url]
    assert "WARNING: no registered md5 for sd-v1-4.ckpt" in out
    assert sorted(os.listdir(save_dir)) == [
        "img2img_0.png", "img2img_1.png", "inpainting_0.png"]
    assert scored == ["psnr"] and "[golden] scored: ['psnr']" in out
    assert "over 3 images" in _lines(out)["PSNR"]
    _same_as_get_metric(out, capsys, [[
        "--metric", "psnr", "--root", str(save_dir), "--gt_root",
        str(data_root / "gt")]])
