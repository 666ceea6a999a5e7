"""The port's PNG decoder against PIL, on every kind of PNG that PIL's
``Image.open(...).convert("RGB")`` reads (``sige_tpu.data.load_image``'s
path), with exact equality:

  * what PIL writes in each of its PNG modes (1, L, P, LA, I;16, RGB,
    RGBA), also with transparency;
  * what PIL does not write, from a small encoder
    (``tests/torch_png_writer.py``, which the card tests use too, with
    its expectation held to PIL here): every color type
    at every bit depth the format allows (16-bit RGB and RGBA, grey and
    palette at 1, 2 and 4 bits, grey + alpha at 16), each with and
    without Adam7 interlacing, at sizes that leave Adam7 passes empty;
  * the port's ``load_image`` equals ``sige_tpu``'s on each;
  * a JPEG, or any other non-PNG file, raises with an error that names
    the format;
  * ``data.resize_bicubic`` equals PIL's 8-bit bicubic resize to the bit
    (down, up, each axis alone, to and from one pixel).
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from sige_torch.data import load_image, resize_bicubic
from sige_torch.demo.png import decode_png
from sige_tpu.data import load_image as jload_image
from torch_png_writer import CASES, encode, expected_rgb, pixels

SIZES = [(1, 1), (3, 2), (5, 7), (9, 13), (16, 17)]


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _check(tmp_path, data, what, expected=None):
    want = _pil_rgb(data)
    if expected is not None:  # the writer's own expectation (the card's)
        np.testing.assert_array_equal(expected, want, err_msg=what)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape[:2] == want.shape[:2], what
    np.testing.assert_array_equal(got[..., :3], want, err_msg=what)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(load_image(str(path)),
                                  jload_image(str(path)), err_msg=what)


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("color,depth,interlace", CASES)
def test_decode_equals_pil_on_every_color_type_and_depth(tmp_path, color,
                                                         depth, interlace):
    rng = np.random.default_rng(100 * color + depth + 7 * interlace)
    palette = None
    if color == 3:
        palette = rng.integers(0, 256, (12, 3))
    for h, w in SIZES:
        px = pixels(rng, h, w, color, depth)
        data = encode(px, color, depth, interlace, palette)
        _check(tmp_path, data, f"{h}x{w}",
               expected_rgb(px, color, depth, palette))
    if color == 3:  # with a tRNS chunk, which convert("RGB") drops
        data = encode(pixels(rng, 6, 5, color, depth), color, depth,
                      interlace, palette, trns=bytes(range(0, 240, 20)))
        _check(tmp_path, data, "tRNS")


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "I;16", "RGB",
                                  "RGBA", "P+transparency", "L+interlace"])
def test_decode_equals_pil_on_what_pil_writes(tmp_path, mode):
    rng = np.random.default_rng(5)
    h, w = 11, 14
    kw = {}
    if mode == "1":
        img = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    elif mode in ("L", "L+interlace"):
        img = Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8))
        if mode == "L+interlace":
            kw = {"interlace": 1}  # PIL writes no Adam7: the file is plain
    elif mode.startswith("P"):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                           dtype=np.uint8)).quantize(17)
        if mode == "P+transparency":
            kw = {"transparency": 3}
    elif mode == "LA":
        img = Image.fromarray(rng.integers(0, 256, (h, w, 2),
                                           dtype=np.uint8), "LA")
    elif mode == "I;16":
        img = Image.fromarray(rng.integers(0, 1000, (h, w)).astype(np.uint16))
    else:
        img = Image.fromarray(rng.integers(0, 256, (h, w, len(mode)),
                                           dtype=np.uint8), mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    assert Image.open(io.BytesIO(buf.getvalue())).mode == img.mode
    _check(tmp_path, buf.getvalue(), mode)


def test_other_formats_raise_with_their_name(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (8, 8, 3), np.uint8)
    for fmt, name in (("JPEG", "JPEG"), ("GIF", "GIF"), ("BMP", "BMP"),
                      ("TIFF", "TIFF")):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format=fmt)
        with pytest.raises(ValueError, match=f"a {name} image"):
            decode_png(buf.getvalue())
        path = tmp_path / f"x.{fmt.lower()}"
        path.write_bytes(buf.getvalue())
        with pytest.raises(ValueError, match=name):
            load_image(str(path))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"not an image at all")
    # a color type and depth the format does not allow
    bad = encode(np.zeros((2, 2, 3), np.int64), 2, 8, 0).replace(
        struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0),
        struct.pack(">IIBBBBB", 2, 2, 4, 2, 0, 0, 0))
    with pytest.raises(ValueError):
        decode_png(bad)


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_resize_bicubic_equals_pil_exactly(kind):
    rng = np.random.default_rng(3)
    for h, w in ((37, 53), (32, 64), (5, 3), (1, 1)):
        if kind == "random":
            a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            yy, xx = np.mgrid[:h, :w]
            a = np.stack([yy * 9 % 256, xx * 5 % 256, (xx + yy) * 3 % 256],
                         -1).astype(np.uint8)
        for size in ((16, 24), (64, 100), (h, 2 * w), (2 * h, w), (9, 7),
                     (1, 1), (3, 40)):
            want = np.asarray(Image.fromarray(a).resize(
                (size[1], size[0]), Image.BICUBIC))
            np.testing.assert_array_equal(resize_bicubic(a, size), want,
                                          err_msg=f"{h}x{w} -> {size}")
