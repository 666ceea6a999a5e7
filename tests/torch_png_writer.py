"""A small PNG writer for the port's codec tests: every color type at
every bit depth the format allows, with or without Adam7 interlacing,
rows filtered with None and Sub, and what PIL's ``convert("RGB")`` reads
from each (held to PIL in ``tests/test_torch_png.py``; the card tests
use it where there is no PIL). numpy and zlib only.
"""

import struct
import zlib

import numpy as np

from sige_torch.demo.png import ADAM7

# samples per pixel of each color type; the depths the format allows
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
CASES = [(c, d, i) for c in SAMPLES for d in DEPTHS[c] for i in (0, 1)]


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _pack_rows(values, depth, bpp):
    """[h, w * samples] sample values -> scanlines, each led by filter
    byte 0 (none) or, on odd rows at depth >= 8, filter 1 (sub, over
    ``bpp`` bytes per pixel)."""
    h, n = values.shape
    out = []
    for r in range(h):
        v = values[r].astype(np.int64)
        if depth == 16:
            row = np.stack([v >> 8, v & 0xFF], -1).reshape(-1).astype(np.uint8)
        elif depth == 8:
            row = v.astype(np.uint8)
        else:
            bits = ((v[:, None] >> np.arange(depth - 1, -1, -1)) & 1)
            row = np.packbits(bits.reshape(-1).astype(np.uint8))
        kind = 1 if depth >= 8 and r % 2 else 0
        if kind == 1:
            row = row.astype(np.int64)
            row = ((row - np.concatenate([np.zeros(bpp, np.int64),
                                          row[:-bpp]])) % 256).astype(np.uint8)
        out.append(bytes([kind]) + row.tobytes())
    return b"".join(out)


def encode(pixels, color, depth, interlace, palette=None, trns=None):
    """A PNG of ``pixels`` ([h, w, samples] sample values) at ``depth``."""
    h, w, s = pixels.shape
    bpp = max(1, s * depth // 8)
    if interlace:
        parts = []
        for c0, r0, dc, dr in ADAM7:
            sub = pixels[r0::dr, c0::dc]
            if sub.size:
                parts.append(_pack_rows(sub.reshape(sub.shape[0], -1), depth,
                                        bpp))
        raw = b"".join(parts)
    else:
        raw = _pack_rows(pixels.reshape(h, -1), depth, bpp)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def pixels(rng, h, w, color, depth):
    top = (1 << depth) - 1
    if color == 3:
        top = min(top, 11)  # a palette shorter than 2 ** depth entries
    px = rng.integers(0, top + 1, (h, w, SAMPLES[color]))
    if depth == 16:  # 16-bit grey: values under and over 255
        px[::2] = rng.integers(0, 256, px[::2].shape)
    return px


def expected_rgb(px, color, depth, palette=None):
    """[h, w, 3] uint8: what PIL's ``convert("RGB")`` reads from a PNG of
    ``px``: a palette expanded, 16-bit samples' high byte (16-bit grey
    clipped to 255: PIL reads it as a 16-bit integer image), grey depths
    below 8 scaled to 0-255, grey repeated, alpha dropped."""
    px = np.asarray(px, np.int64)
    if color == 3:
        lut = np.zeros((256, 3), np.int64)
        lut[:len(palette)] = palette
        return lut[px[..., 0]].astype(np.uint8)
    if depth == 16:
        px = np.minimum(px, 255) if color == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1).astype(np.uint8)
    return px[..., :3].astype(np.uint8)
