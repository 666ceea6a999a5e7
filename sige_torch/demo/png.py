"""A PNG codec in numpy and zlib, for the demo server (the machine with
the card has no imaging library).

:func:`decode_png` reads 8-bit RGB and RGBA images without interlacing,
with any of the five row filters (what a browser canvas's ``toDataURL``
writes); :func:`encode_png` writes 8-bit RGB or RGBA with filter 0
(none) on every row. Anything else raises :class:`ValueError`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {2: 3, 6: 4}  # color type -> samples per pixel (RGB, RGBA)


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG: bad signature")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9): [height, width * bpp]
    uint8. None and Up are whole-row numpy operations, Sub a prefix sum
    modulo 256; Average and Paeth depend on the byte ``bpp`` to the left
    after reconstruction, so they run byte by byte."""
    stride = width * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = (np.cumsum(line.reshape(width, bpp).astype(np.int64),
                             axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev  # uint8 wraps modulo 256
        elif kind in (3, 4):
            cur = _unfilter_slow(kind, line.tobytes(), prev.tobytes(), bpp)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[r] = cur
        prev = cur
    return out


def _unfilter_slow(kind: int, line: bytes, prev: bytes, bpp: int
                   ) -> np.ndarray:
    """Average (3) or Paeth (4) on one row."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] or [H, W, 4] uint8 from the bytes of an 8-bit RGB or
    RGBA PNG."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in CHANNELS:
        raise ValueError(f"PNG of bit depth {depth} and color type {color}: "
                         "only 8-bit RGB and RGBA are read")
    if compression or filt or interlace:
        raise ValueError("interlaced or non-standard PNG")
    bpp = CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    return _unfilter(raw, height, width, bpp).reshape(height, width, bpp)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(image: np.ndarray) -> bytes:
    """The bytes of an 8-bit PNG of ``image`` ([H, W, 3] or [H, W, 4]
    uint8), filter 0 on every row."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (
            3, 4):
        raise ValueError(f"encode_png takes [H, W, 3|4] uint8, got "
                         f"{image.dtype} {image.shape}")
    height, width, bpp = image.shape
    color = {3: 2, 4: 6}[bpp]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           image.reshape(height, width * bpp)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                          color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))
