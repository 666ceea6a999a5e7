"""Image IO (NHWC float arrays) on the port's own PNG codec — the port of
``sige_tpu.data.image``, which reads and writes through PIL. The machine
with the card has no PIL: :func:`load_image` reads 8-bit RGB and RGBA PNGs
with :mod:`sige_torch.demo.png` and resizes as PIL's ``BICUBIC`` does
(Keys' cubic with a = -0.5, widened by the scale factor when it shrinks)
through ``F.interpolate(mode="bicubic", antialias=True)`` in float64 on
the CPU, one axis at a time and rounded to 8 bits after each, as PIL
does."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..demo.png import decode_png, encode_png


def _resize_axis(x: torch.Tensor, size) -> torch.Tensor:
    y = F.interpolate(x, size=size, mode="bicubic", antialias=True,
                      align_corners=False)
    return torch.clamp(torch.floor(y + 0.5), 0, 255)


def resize_bicubic(img: np.ndarray, size) -> np.ndarray:
    """[H, W, C] uint8 -> [size[0], size[1], C] uint8, PIL's bicubic
    resampling: the horizontal pass, then the vertical one, each rounded
    and clipped to 8 bits as PIL stores it."""
    H, W = img.shape[:2]
    out_h, out_w = (int(s) for s in size)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float64))
    x = x.permute(2, 0, 1)[None]
    if out_w != W:
        x = _resize_axis(x, (H, out_w))
    if out_h != H:
        x = _resize_axis(x, (out_h, out_w))
    return x[0].permute(1, 2, 0).numpy().astype(np.uint8)


def load_image(path: str, size=None, mult_of: int | None = None) -> np.ndarray:
    """Load an 8-bit RGB or RGBA PNG to [H, W, 3] float32 in [0, 1] (the
    alpha channel is dropped, as PIL's ``convert("RGB")`` does). ``size``
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
