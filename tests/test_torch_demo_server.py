"""The port's demo server, canvas ops and PNG codec (the server's host
has no imaging library, so the port carries its own codec).

  * the codec against PIL: PIL-encoded RGB and RGBA images of several
    sizes and contents decode exactly; rows written with each of the five
    filter types decode exactly; the port's encoder is read back by PIL;
    grey, palette and 16-bit grey as PIL converts them to RGB; what is
    not a PNG, or a corrupt one, raises ``ValueError``;
  * the canvas ops equal ``sige_tpu.demo.canvas``'s;
  * the in-process HTTP server at ``--tiny`` on the CPU: the page, the
    stamps, reset -> generate -> apply -> generate, each image equal to a
    twin runner's direct output after the server's uint8 conversion; a
    session out of range, a payload that is not an image and a request
    without an image answer 400, an image of another size is resized to
    R x R as sige_tpu's server resizes it; two sessions over HTTP keep their own state
    (``tests/test_demo_server.py:55-178``); the command line raises
    without a GPU unless ``--device cpu``; ``--restore_from`` reads a
    checkpoint (a missing file raises) and ``--image`` is resized to
    R x R.
"""

import base64
import io
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib
from http.server import HTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from sige_tpu.demo import canvas as j_canvas
from sige_torch.demo import canvas, server
from sige_torch.demo.png import decode_png, encode_png
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

R = 32
ARGS = ["--tiny", "--resolution", str(R), "--sample_steps", "4",
        "--device", "cpu"]


# --- the PNG codec ------------------------------------------------------------

SIZES = [(1, 1), (5, 7), (32, 32), (48, 64)]


def _content(kind, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if kind == "solid":
        return np.broadcast_to(
            rng.integers(0, 256, c, dtype=np.uint8), (h, w, c)).copy()
    yy, xx = np.mgrid[0:h, 0:w]  # smooth: the encoder picks Paeth and Sub
    planes = [(3 * xx + yy) % 256, (xx * yy) % 256, (5 * yy) % 256,
              (255 - xx) % 256]
    return np.stack(planes[:c], -1).astype(np.uint8)


def _pil_png(a):
    buf = io.BytesIO()
    Image.fromarray(a, "RGBA" if a.shape[2] == 4 else "RGB").save(
        buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kind", ["random", "solid", "gradient"])
def test_decode_reads_what_pil_writes(channels, kind):
    for h, w in SIZES:
        a = _content(kind, h, w, channels)
        np.testing.assert_array_equal(decode_png(_pil_png(a)), a,
                                      err_msg=f"{h}x{w}")


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kind", ["random", "gradient"])
def test_pil_reads_what_encode_writes(channels, kind):
    for h, w in SIZES:
        a = _content(kind, h, w, channels, seed=1)
        back = np.asarray(Image.open(io.BytesIO(encode_png(a))))
        np.testing.assert_array_equal(back, a, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(decode_png(encode_png(a)), a)


def _filter_row(kind, row, prev, bpp):
    """One row filtered with ``kind`` (PNG spec section 9), byte by byte."""
    out = bytearray(len(row))
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (row[i] - pred) % 256
    return bytes([kind]) + bytes(out)


def _png_with_filters(a):
    """A PNG of ``a`` whose rows cycle through filter types 0-4."""
    h, w, c = a.shape
    rows, prev = [], bytes(w * c)
    for r in range(h):
        row = a[r].tobytes()
        rows.append(_filter_row(r % 5, row, prev, c))
        prev = row

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_undoes_every_filter_type(channels):
    for kind in ("random", "gradient"):
        a = _content(kind, 20, 13, channels, seed=2)
        data = _png_with_filters(a)
        # PIL agrees that the file holds a
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                      a)
        np.testing.assert_array_equal(decode_png(data), a)


def test_decode_refuses_what_it_does_not_read():
    """Grey, palette and 16-bit grey PNGs are read as PIL converts them
    to RGB (tests/test_torch_png.py covers every color type and depth);
    what is not a PNG, or a corrupt one, raises."""
    a = _content("random", 6, 6, 3)
    good = _pil_png(a)
    for mode, arr in (("L", a[..., 0]), ("P", a[..., 0]),
                      ("I;16", a[..., 0].astype(np.uint16) * 200)):
        buf = io.BytesIO()
        Image.fromarray(arr, None if mode == "I;16" else mode).save(
            buf, format="PNG")
        np.testing.assert_array_equal(
            decode_png(buf.getvalue()),
            np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + good[6:])
    corrupt = bytearray(good)
    corrupt[40] ^= 0xFF  # inside IHDR's or IDAT's payload: CRC mismatch
    with pytest.raises(ValueError):
        decode_png(bytes(corrupt))
    with pytest.raises(ValueError):
        encode_png(a.astype(np.float32))


# --- the canvas ops -----------------------------------------------------------


@pytest.mark.parametrize("name", canvas.STAMP_NAMES)
def test_canvas_ops_equal_sige_tpus(name):
    assert canvas.STAMP_NAMES == j_canvas.STAMP_NAMES
    for size in (16, 64):
        np.testing.assert_array_equal(canvas.make_stamp(name, size),
                                      j_canvas.make_stamp(name, size))
    img = np.random.default_rng(3).random((R, R, 3)).astype(np.float32)
    stamp = canvas.make_stamp(name, 16)
    for x, y, scale in ((16, 16, 1.0), (0, 0, 2.0), (31, 5, 0.5),
                        (40, 40, 1.0)):
        np.testing.assert_array_equal(
            canvas.place_stamp(img, stamp, x, y, scale),
            j_canvas.place_stamp(img, stamp, x, y, scale))
    with pytest.raises(ValueError):
        canvas.make_stamp("pie")


def test_undo_stack_keeps_the_last_snapshots():
    ours, theirs = canvas.UndoStack(limit=3), j_canvas.UndoStack(limit=3)
    frames = [np.full((2, 2, 3), v, np.float32) for v in range(5)]
    for f in frames:
        ours.push(f)
        theirs.push(f)
    assert len(ours) == len(theirs) == 3
    while len(theirs):
        np.testing.assert_array_equal(ours.pop(), theirs.pop())
    assert ours.pop() is None


# --- the HTTP server ----------------------------------------------------------


def _data_url(arr):
    return ("data:image/png;base64,"
            + base64.b64encode(encode_png(server.to_uint8(arr))).decode())


def _decode(url):
    return decode_png(base64.b64decode(url.split(",", 1)[1]))


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as res:
        return json.loads(res.read())


def _post_status(url, obj):
    try:
        _post(url, obj)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    return 200, None


class Served:
    """An in-process server over ``runner`` on a free port."""

    def __init__(self, runner, base, sessions=1):
        self.httpd = HTTPServer(("127.0.0.1", 0), server.make_handler(
            runner, base, R, sessions=sessions))
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def served():
    runner, base = server.build(server.parse_args(ARGS))
    twin, _ = server.build(server.parse_args(ARGS))
    s = Served(runner, base)
    yield s, twin, base
    s.close()


def test_page_and_stamps(served):
    s, _, _ = served
    with urllib.request.urlopen(s.url, timeout=60) as res:
        page = res.read().decode()
    assert "sige-torch" in page and f"const R = {R}" in page
    for frag in ("brush", "eraser", "fill", "stamp", "undo()", "snapshot()"):
        assert frag in page
    with urllib.request.urlopen(s.url + "/stamps", timeout=60) as res:
        stamps = json.loads(res.read())
    assert set(stamps) == set(canvas.STAMP_NAMES)
    for name, url in stamps.items():
        want = canvas.make_stamp(name)
        got = _decode(url)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, server.to_uint8(want))


def test_reset_generate_apply_flow(served):
    s, twin, base = served
    js = _post(s.url + "/reset", {})
    assert js["ms"] > 0
    np.testing.assert_array_equal(
        _decode(js["base"]), server.to_uint8(twin.reset_base_image(base)))

    edited = base.copy()
    edited[8:16, 10:20] = 0.9
    sent = server.to_uint8(edited).astype(np.float32) / 255.0  # what travels
    js = _post(s.url + "/generate", {"image": _data_url(edited)})
    assert js["ms"] > 0
    want = twin.generate(sent)
    np.testing.assert_array_equal(_decode(js["image"]),
                                  server.to_uint8(want))
    assert np.abs(want - sent).max() > 1e-2  # a real conversion

    js = _post(s.url + "/apply", {"image": _data_url(edited)})
    np.testing.assert_array_equal(
        _decode(js["image"]),
        server.to_uint8(twin.generate(sent, sparse_update=True)))
    # after apply, regenerating the same image is a no-op edit: the base
    # image back
    js = _post(s.url + "/generate", {"image": _data_url(edited)})
    noop = twin.generate(sent)
    np.testing.assert_allclose(noop, sent, atol=1e-6)
    np.testing.assert_array_equal(_decode(js["image"]),
                                  server.to_uint8(noop))


def test_bad_requests_answer_400(served):
    """A session out of range, a request without an image and a payload
    that is not an image answer 400; an edit of another size (R x 2R) is
    resized to R x R as sige_tpu's server resizes it (PIL's bicubic) and
    answered 200."""
    s, twin, base = served
    code, js = _post_status(s.url + "/reset", {"session": 9})
    assert code == 400 and "out of range" in js["error"]
    code, js = _post_status(s.url + "/generate", {})
    assert code == 400
    for image in ("data:image/png;base64," + base64.b64encode(
            b"not an image").decode(), "no data url", 7):
        code, js = _post_status(s.url + "/generate", {"image": image})
        assert code == 400 and "bad image" in js["error"]

    from sige_tpu.demo.server import _png_to_array as j_png_to_array

    _post(s.url + "/reset", {})
    twin.reset_base_image(base)
    edited = base.copy()
    edited[4:14, 6:22] = 0.8
    wide = _data_url(np.repeat(edited, 2, axis=1))  # R x 2R
    sent = j_png_to_array(wide, R)
    np.testing.assert_array_equal(server.png_to_array(wide, R), sent)
    js = _post(s.url + "/generate", {"image": wide})
    want = server.to_uint8(twin.generate(sent))
    got = _decode(js["image"]).astype(np.int64)
    assert got.shape == (R, R, 3)
    np.testing.assert_allclose(got, want, atol=2, rtol=0)  # 2/255
    js = _post(s.url + "/apply", {"image": wide})
    np.testing.assert_allclose(
        _decode(js["image"]).astype(np.int64),
        server.to_uint8(twin.generate(sent, sparse_update=True)), atol=2,
        rtol=0)


def test_multi_session_http_flow():
    """--sessions 2: two users with their own edits; one user's apply
    does not reach the other's state (tests/test_demo_server.py:102)."""
    runner, base = server.build(server.parse_args(ARGS + ["--sessions", "2"]))
    s = Served(runner, base, sessions=2)
    try:
        for sid in (0, 1):
            _post(s.url + "/reset", {"session": sid})
        e0, e1 = base.copy(), base.copy()
        e0[4:12, 6:14] = 0.9
        e1[20:28, 2:26] = 0.1
        js1 = _post(s.url + "/generate", {"image": _data_url(e1),
                                          "session": 1})
        _post(s.url + "/apply", {"image": _data_url(e0), "session": 0})
        # session 0's baseline moved; session 1's did not
        js = _post(s.url + "/generate", {"image": _data_url(e0),
                                         "session": 0})
        sent = server.to_uint8(e0).astype(np.float32) / 255.0
        assert np.abs(_decode(js["image"]) / 255.0 - sent).max() < 1.01 / 255
        js = _post(s.url + "/generate", {"image": _data_url(e1),
                                         "session": 1})
        assert js["image"] == js1["image"]
        code, _ = _post_status(s.url + "/reset", {"session": 2})
        assert code == 400
    finally:
        s.close()


def test_command_line_needs_a_gpu_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_device = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.build(server.parse_args(no_device))
    with pytest.raises(FileNotFoundError):
        server.build(server.parse_args(ARGS + ["--restore_from", "x.pth"]))
    # a base image from a PNG or a .npy of R x R pixels
    img = np.random.default_rng(4).random((R, R, 3)).astype(np.float32)
    (tmp_path / "base.png").write_bytes(encode_png(server.to_uint8(img)))
    np.save(tmp_path / "base.npy", img)
    np.testing.assert_allclose(
        server.load_image(str(tmp_path / "base.png"), R), img, atol=1 / 255)
    np.testing.assert_array_equal(
        server.load_image(str(tmp_path / "base.npy"), R), img)
    # another size is resized to R x R, as PIL's bicubic resize does
    from sige_torch.data import resize_bicubic
    for name in ("base.png", "base.npy"):
        small = server.load_image(str(tmp_path / name), 16)
        np.testing.assert_array_equal(
            small, resize_bicubic(server.to_uint8(img), (16, 16)) / np.float32(
                255.0))
