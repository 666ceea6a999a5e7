"""A PNG codec in numpy and zlib, for the demo server and the image
loader (the machine with the card has no imaging library).

:func:`decode_png` reads every PNG: color types 0 (grey), 2 (RGB), 3
(palette), 4 (grey + alpha) and 6 (RGBA), at every bit depth the format
allows (1, 2 and 4 for grey and palette, 8, and 16 for all but palette),
with or without Adam7 interlacing, and any of the five row filters. It
returns 8-bit samples as PIL's ``Image.open`` followed by ``convert`` to
RGB (or RGBA for the alpha types) gives them: grey and palette are
expanded to RGB, a ``tRNS`` chunk is ignored, depths 1, 2 and 4 of grey
are scaled to 0-255, 16-bit samples keep their high byte, except 16-bit
grey, which PIL reads as a 16-bit integer image and clips to 255.
:func:`encode_png` writes 8-bit RGB or RGBA with filter 0 (none) on every
row. Other formats, and malformed files, raise :class:`ValueError`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: color type -> (samples per pixel, allowed bit depths)
COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
               3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
#: the seven Adam7 passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
#: leading bytes of image formats that are not PNG, to name them in errors
OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"),
                 (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                 (b"RIFF", "RIFF (WebP)"))


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        name = next((n for magic, n in OTHER_FORMATS
                     if data.startswith(magic)), None)
        what = f"a {name} image" if name else "not an image format read here"
        raise ValueError(f"not a PNG (bad signature): {what}; only PNG is "
                         "read")
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


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9) of ``rows`` ([height,
    1 + stride] uint8, each row led by its filter type): [height, stride]
    uint8. ``bpp`` is the filter's byte distance (bytes per pixel, at
    least 1). None and Up are whole-row numpy operations, Sub a prefix sum
    modulo 256; Average and Paeth depend on the byte ``bpp`` to the left
    after reconstruction, so they run byte by byte."""
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # the stride is a multiple of bpp
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(-1)
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


def _stride(width: int, samples: int, depth: int) -> int:
    """Bytes of one scanline's pixels (filter byte excluded)."""
    return (width * samples * depth + 7) // 8


def _read_image(raw: memoryview, width: int, height: int, samples: int,
                depth: int) -> np.ndarray:
    """[height, width, samples] sample values (uint8, or uint16 at depth
    16) of one non-interlaced image or one Adam7 pass, from exactly its
    bytes in ``raw``."""
    stride = _stride(width, samples, depth)
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    data = _unfilter(rows, max(1, samples * depth // 8))
    if depth == 8:
        return data.reshape(height, width, samples)
    if depth == 16:
        wide = data.reshape(height, width * samples, 2).astype(np.uint16)
        return ((wide[..., 0] << 8) | wide[..., 1]).reshape(
            height, width, samples)
    # 1, 2 or 4 bits, most significant first, rows padded to a byte
    bits = np.unpackbits(data, axis=1)[:, :width * samples * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    values = bits.reshape(height, width * samples, depth) @ weights
    return values.astype(np.uint8).reshape(height, width, samples)


def _to_8bit(img: np.ndarray, color: int, depth: int,
             palette: np.ndarray | None) -> np.ndarray:
    """8-bit RGB or RGBA, as PIL converts each mode (see the module
    docstring)."""
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)  # entries past PLTE read black
        lut[:len(palette)] = palette
        return lut[img[..., 0]]
    if depth == 16:
        img = (np.minimum(img, 255) if color == 0 else img >> 8)
    elif depth < 8:  # grey only: 1 -> 255, 2 -> 85, 4 -> 17 per step
        img = img * np.uint8(255 // ((1 << depth) - 1))
    img = img.astype(np.uint8)
    if color == 0:
        return np.repeat(img, 3, axis=-1)
    if color == 4:
        return img[..., [0, 0, 0, 1]]
    return img


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] uint8 (RGB), or [H, W, 4] (RGBA) for the color types with
    alpha, from the bytes of a PNG (see the module docstring for how each
    color type and bit depth maps to 8-bit samples)."""
    header, idat, palette = None, [], None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3 or not 0 < len(payload) <= 768:
                raise ValueError("PNG PLTE of the wrong size")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, compression, filt, interlace = header
    if color not in COLOR_TYPES or depth not in COLOR_TYPES[color][1]:
        raise ValueError(f"PNG of bit depth {depth} and color type {color} "
                         "is not a valid combination")
    if compression or filt or interlace not in (0, 1):
        raise ValueError("PNG with a non-standard compression, filter or "
                         "interlace method")
    samples = COLOR_TYPES[color][0]
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    passes = ([(0, 0, 1, 1)] if interlace == 0 else ADAM7)
    img = np.zeros((height, width, samples),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for c0, r0, dc, dr in passes:
        pw, ph = -(-(width - c0) // dc), -(-(height - r0) // dr)
        if pw <= 0 or ph <= 0:
            continue  # an empty Adam7 pass holds no bytes
        n = ph * (_stride(pw, samples, depth) + 1)
        if pos + n > len(raw):
            raise ValueError("PNG image data of the wrong size")
        img[r0::dr, c0::dc] = _read_image(raw[pos:pos + n], pw, ph, samples,
                                          depth)
        pos += n
    if pos != len(raw):
        raise ValueError("PNG image data of the wrong size")
    return _to_8bit(img, color, depth, palette)


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
