"""The port's data and utility modules against sige_tpu's (the machine with
the card has neither PyYAML nor PIL, so the port reads YAML and PNG
itself):

  * ``utils.config``: ``load_config`` equals sige_tpu's (PyYAML's
    ``safe_load``) on every file in ``configs/``, and on the YAML features
    its reader supports; what it does not read raises; ``override_config``
    and ``parse_value`` match;
  * ``data.image``: ``load_image`` equals sige_tpu's (PIL) exactly without
    a resize and within 2/255 after PIL's bicubic resize (down, up, and
    each axis alone); ``save_image`` writes what PIL reads back;
  * ``data.datasets``: both datasets yield sige_tpu's items;
  * ``utils.watermark``: ``put_watermark`` equals sige_tpu's exactly and
    the payload decodes; ``utils.html``: the same gallery.
"""

import pathlib

import numpy as np
import pytest
import yaml
from PIL import Image

from sige_torch.data import (CityscapesEditDataset, SDEditDataset, load_image,
                             save_image)
from sige_torch.utils import config, html, watermark
from sige_tpu.data import CityscapesEditDataset as JCityscapes
from sige_tpu.data import SDEditDataset as JSDEdit
from sige_tpu.data import load_image as jload_image
from sige_tpu.utils import config as jconfig
from sige_tpu.utils import html as jhtml
from sige_tpu.utils import watermark as jwatermark

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").iterdir()
                 if p.suffix in (".yml", ".yaml"))
# tests/test_cli.py's tiny overrides
DDPM_TINY_HPARAMS = (
    "model.ch=16 model.ch_mult=1,2 model.num_res_blocks=1 "
    "model.attn_resolutions=16 model.sparse_resolution_threshold=32 "
    "model.num_groups=8 data.image_size=32 "
    "sampling.sample_steps=2 sampling.noise_level=100")


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_equals_sige_tpu(name):
    path = str(ROOT / "configs" / name)
    ours, theirs = config.load_config(path), jconfig.load_config(path)
    assert ours == theirs
    assert isinstance(ours, config.AttrDict)
    assert ours.model == theirs.model


YAML_CASES = [
    "a: 1e-4\nb: 1.0e-4\nc: .5\nd: 6.\ne: -1.5\nf: +.inf",
    "a: 0x1F\nb: 017\nc: 1_000\nd: 1:30\ne: -0",
    "a: yes\nb: Off\nc: TRUE\nd: ~\ne: null\nf:",
    "a: 'x # y'\nb: \"q\"\nc: it''s\nd: x#y  # comment\ne: dpmsolver++",
    "# head\na:\n  b:\n    c: [ ]\n    d: {x: 1, y: [1, 2, {z: null}]}\n"
    "  e: -3  # tail\nf: [a b, 'c, d']",
]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_reader_resolves_as_pyyaml(text):
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n  - 2", "a: &x 1\nb: *x",
                                  "a: |\n  text", "a: [1, 2"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)


def test_override_config_matches():
    ours = config.load_config(str(ROOT / "configs/church_ddpm256-sige.yml"))
    theirs = jconfig.load_config(str(ROOT / "configs/church_ddpm256-sige.yml"))
    hp = DDPM_TINY_HPARAMS + " new.key=abc sampling.eta=0.5 data.rescaled=false"
    assert config.override_config(ours, hp) == jconfig.override_config(
        theirs, hp)
    assert ours.model.ch == 16 and ours.model.ch_mult == [1, 2]
    for value, original in (("none", None), ("3", [1]), ("1,2.5,x", None),
                            ("True", None), ("2e-3", None)):
        assert config.parse_value(value, original) == jconfig.parse_value(
            value, original)


def _image(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return np.stack([yy * 5 % 256, xx * 4 % 256, (xx + yy) * 3 % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_load_image_equals_pil(tmp_path, kind, mode):
    a = _image(kind, 37, 53)
    if mode == "RGBA":
        a = np.concatenate([a, a[..., :1]], axis=-1)
    path = str(tmp_path / "x.png")
    Image.fromarray(a, mode).save(path)
    np.testing.assert_array_equal(load_image(path), jload_image(path))
    for size in [(16, 24), (64, 100), (37, 100), (74, 53), (9, 7), (37, 20)]:
        ours, theirs = load_image(path, size=size), jload_image(path,
                                                                size=size)
        assert ours.shape == theirs.shape == size + (3,)
        np.testing.assert_allclose(ours, theirs, atol=2 / 255, rtol=0,
                                   err_msg=str(size))
    np.testing.assert_array_equal(load_image(path, mult_of=16),
                                  jload_image(path, mult_of=16))


def test_save_image_reads_back_in_pil(tmp_path):
    a = _image("random", 20, 30).astype(np.float32) / 255.0
    save_image(str(tmp_path / "sub" / "a.png"), a)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "sub" / "a.png")),
        (a * 255.0 + 0.5).astype(np.uint8))


def test_datasets_equal_sige_tpu(tmp_path):
    sdedit = tmp_path / "sdedit"
    for sub in ("original", "edited"):
        (sdedit / sub).mkdir(parents=True)
        for i, name in enumerate(("b", "a", "c")):
            Image.fromarray(_image("random", 8, 8, seed=i + (sub == "edited"))
                            ).save(sdedit / sub / f"{name}.png")
    for metas in (None, ["c", "a"]):
        ours, theirs = SDEditDataset(str(sdedit), metas), JSDEdit(
            str(sdedit), metas)
        assert len(ours) == len(theirs) and ours.names == theirs.names
        for i in range(len(ours)):
            for k in ("original", "edited"):
                np.testing.assert_array_equal(ours[i][k], theirs[i][k])
    city = tmp_path / "city"
    city.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(2):
        files = {}
        for k in ("gt_label", "gt_instance", "synthetic_label",
                  "synthetic_instance"):
            files[k] = f"{k}_{i}.npy"
            np.save(city / files[k], rng.integers(0, 5, (4, 6)))
        rows.append(f"{i},{files['gt_label']},{files['gt_instance']},"
                    f"{files['synthetic_label']},{files['synthetic_instance']}")
    (city / "meta.csv").write_text(
        "id,gt_label,gt_instance,synthetic_label,synthetic_instance\n"
        + "\n".join(rows) + "\n")
    for kw in ({}, {"symmetric": False}, {"image_ids": [1]}):
        ours, theirs = CityscapesEditDataset(str(city), **kw), JCityscapes(
            str(city), **kw)
        assert len(ours) == len(theirs)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys() and a["name"] == b["name"]
            for k in a:
                if k != "name":
                    np.testing.assert_array_equal(a[k], b[k])


def test_watermark_equals_sige_tpu():
    img = _image("random", 256, 200, seed=3)
    enc = watermark.WatermarkEncoder(b"StableDiffusionV1")
    ours = watermark.put_watermark(img, enc)
    theirs = jwatermark.put_watermark(img, jwatermark.WatermarkEncoder(
        b"StableDiffusionV1"))
    np.testing.assert_array_equal(ours, theirs)
    assert enc.decode(ours) == b"StableDiffusionV1"
    assert watermark.put_watermark(img, None) is img


def test_gallery_equals_sige_tpu(tmp_path):
    rows = [{"name": "a", "generated": str(tmp_path / "x" / "a.png")},
            {"name": "b<", "edited": str(tmp_path / "b.png")}]
    html.write_gallery(str(tmp_path / "ours.html"), rows, title="t&")
    jhtml.write_gallery(str(tmp_path / "theirs.html"), rows, title="t&")
    assert (tmp_path / "ours.html").read_text() == (
        tmp_path / "theirs.html").read_text()
