"""Image IO (NHWC float arrays) on the port's own PNG codec — the port of
``sige_tpu.data.image``, which reads and writes through PIL. The machine
with the card has no PIL: :func:`load_image` reads every PNG with
:mod:`sige_torch.demo.png` as PIL's ``convert("RGB")`` gives it, and
:func:`resize_bicubic` resizes as PIL's ``BICUBIC`` does for 8-bit
images, to the bit: Keys' cubic with a = -0.5, widened by the scale
factor when it shrinks, its weights normalized and rounded to 22-bit
fixed point, the horizontal pass and then the vertical one, each rounded
and clipped to 8 bits."""

from __future__ import annotations

import math
import os

import numpy as np

from ..demo.png import decode_png, encode_png

#: fixed-point bits of PIL's 8-bit resampling weights
PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (support 2)."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resample_weights(in_size: int, out_size: int):
    """(first input index [out], fixed-point weights [out, taps]) of one
    axis, computed in the order PIL computes them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(taps)
    live = x[None, :] < xmax[:, None]
    w = np.where(live, _bicubic((x[None, :] + xmin[:, None] - center[:, None]
                                 + 0.5) / filterscale), 0.0)
    total = np.zeros(out_size)
    for t in range(taps):  # summed left to right, as PIL sums
        total = total + w[:, t]
    w = w / np.where(total != 0.0, total, 1.0)[:, None]
    one = float(1 << PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resampling along ``axis`` of uint8 ``img``."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    xmin, fixed = _resample_weights(src.shape[0], out_size)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    last = src.shape[0] - 1
    for t in range(fixed.shape[1]):  # dead taps carry weight 0
        w = fixed[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[np.minimum(xmin + t, last)] * w
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size) -> np.ndarray:
    """[H, W, C] uint8 -> [size[0], size[1], C] uint8, PIL's bicubic
    resampling of 8-bit images (``Image.resize((W, H), BICUBIC)``)."""
    H, W = img.shape[:2]
    out_h, out_w = (int(s) for s in size)
    out = np.asarray(img, np.uint8)
    if out_w != W:
        out = _resample_axis(out, out_w, 1)
    if out_h != H:
        out = _resample_axis(out, out_h, 0)
    return out


def load_image(path: str, size=None, mult_of: int | None = None) -> np.ndarray:
    """Load a PNG to [H, W, 3] float32 in [0, 1], as PIL's
    ``convert("RGB")`` reads it (alpha dropped, grey and palette
    expanded; see :mod:`sige_torch.demo.png`). ``size``
    (H, W) resizes bicubically; ``mult_of`` crops to a multiple (the
    reference loads SD inputs at multiples of 32; reference:
    stable-diffusion/utils.py load_img)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())[..., :3]
    if size is not None:
        img = resize_bicubic(img, size)
    arr = img.astype(np.float32) / 255.0
    if mult_of:
        H, W = arr.shape[:2]
        arr = arr[: H - H % mult_of or H, : W - W % mult_of or W]
    return arr


def save_image(path: str, arr: np.ndarray) -> None:
    """Save [H, W, 3] float in [0, 1] (or uint8) as PNG."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(a))
