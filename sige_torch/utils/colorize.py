"""Label-map visualization: Cityscapes palette, colorization, and the
GauGAN visual-saving helpers.

Reference: gaugan/colorize.py (labelcolormap/Colorize — the 35-entry
Cityscapes palette is a public constant from the Cityscapes label map)
and gaugan/utils.py:78-122 (tensor2im/tensor2label/save_visuals).
NumPy-vectorized instead of the reference's per-label torch masking loop.
The port's copy of ``sige_tpu.utils.colorize``; the PNGs are written by
the port's own codec (:func:`sige_torch.data.save_image`), so no imaging
library is needed.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

_CITYSCAPES_CMAP = np.array(
    [
        (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0),
        (111, 74, 0), (81, 0, 81), (128, 64, 128), (244, 35, 232),
        (250, 170, 160), (230, 150, 140), (70, 70, 70), (102, 102, 156),
        (190, 153, 153), (180, 165, 180), (150, 100, 100), (150, 120, 90),
        (153, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
        (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
        (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90),
        (0, 0, 110), (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142),
    ],
    dtype=np.uint8,
)


def uint82bin(n: int, count: int = 8) -> str:
    """Binary string of ``n`` (reference: gaugan/colorize.py:10-12)."""
    return "".join(str((n >> y) & 1) for y in range(count - 1, -1, -1))


def labelcolormap(n: int) -> np.ndarray:
    """[n, 3] uint8 palette: the Cityscapes map for n==35, otherwise the
    bit-interleaving procedural palette (reference: colorize.py:15-74)."""
    if n == 35:
        return _CITYSCAPES_CMAP.copy()
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i + 1
        for j in range(7):
            s = uint82bin(idx)
            r ^= np.uint8(s[-1]) << (7 - j)
            g ^= np.uint8(s[-2]) << (7 - j)
            b ^= np.uint8(s[-3]) << (7 - j)
            idx >>= 3
        cmap[i] = (r, g, b)
    return cmap


class Colorize:
    """Grayscale label map [H, W] int -> color image [H, W, 3] uint8
    (reference: colorize.py:76-92, vectorized)."""

    def __init__(self, n: int = 35):
        self.cmap = labelcolormap(n)

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels).astype(np.int64)
        labels = np.clip(labels, 0, len(self.cmap) - 1)
        return self.cmap[labels]


def tensor2im(image, imtype=np.uint8, normalize: bool = True) -> np.ndarray:
    """[H, W, C] (or [1, H, W, C]) float image -> uint8. ``normalize``
    means the input is in [-1, 1] (reference: gaugan/utils.py:43-77)."""
    x = np.asarray(image, np.float32)
    if x.ndim == 4:
        x = x[0]
    if normalize:
        x = (x + 1.0) / 2.0
    x = np.clip(x * 255.0, 0, 255)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x.astype(imtype)


def tensor2label(label, n_label: int, imtype=np.uint8) -> np.ndarray:
    """One-hot [H, W, n] (or integer [H, W]) label map -> color image
    (reference: gaugan/utils.py:80-96)."""
    x = np.asarray(label)
    if x.ndim == 4:
        x = x[0]
    if x.ndim == 3 and x.shape[-1] > 1:
        x = np.argmax(x, axis=-1)
    elif x.ndim == 3:
        x = x[..., 0]
    return Colorize(n_label)(x).astype(imtype)


def save_visuals(save_dir: str, visuals: Dict[str, np.ndarray], name: str,
                 input_nc: int = 35) -> None:
    """Save each visual under ``save_dir/<kind>/<name>.png``; label kinds
    are colorized (reference: gaugan/utils.py:113-122). Every PNG is 8-bit
    RGB."""
    from ..data import save_image

    for k, v in visuals.items():
        path = os.path.join(save_dir, k, f"{name}.png")
        if k in ("original_label", "edited_label"):
            arr = tensor2label(v, input_nc + 1)
        else:
            arr = tensor2im(v)
        save_image(path, arr)
