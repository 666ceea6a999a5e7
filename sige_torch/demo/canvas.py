"""Canvas editing ops shared by the demo UI and its tests (the port's own
copy of ``sige_tpu.demo.canvas``, numpy only).

The reference demo's PyQt canvas implements brush / eraser / stamp
painting with the stamp drawn centered on the click
(reference: diffusion_demo/ui/canvas.py:289-292 stamp_mousePressEvent,
ui/hparams.py:41-62 stamp set). The web demo mirrors the same ops in
browser JS; this module is the server-side twin so the tool semantics
are unit-testable without a JS engine.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def make_stamp(name: str, size: int = 64) -> np.ndarray:
    """A procedural RGBA stamp ([size, size, 4] float in [0, 1]).

    The reference ships baked-in stamp PNGs (pies); with zero assets we
    draw simple shapes — the mechanism (pick a stamp, click to place it)
    is the parity point, not the artwork.
    """
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    cx = cy = (s - 1) / 2.0
    r = np.hypot(xx - cx, yy - cy)
    img = np.zeros((s, s, 4), np.float32)
    if name == "sun":
        disk = r < 0.42 * s
        img[disk] = (1.0, 0.85, 0.2, 1.0)
    elif name == "moon":
        disk = (r < 0.42 * s) & (np.hypot(xx - cx - 0.18 * s, yy - cy)
                                 > 0.38 * s)
        img[disk] = (0.95, 0.95, 0.85, 1.0)
    elif name == "tree":
        canopy = np.hypot(xx - cx, yy - 0.35 * s) < 0.3 * s
        trunk = (np.abs(xx - cx) < 0.06 * s) & (yy > 0.5 * s) & (yy < 0.95 * s)
        img[canopy] = (0.15, 0.5, 0.2, 1.0)
        img[trunk] = (0.4, 0.25, 0.1, 1.0)
    elif name == "house":
        body = (np.abs(xx - cx) < 0.32 * s) & (yy > 0.45 * s) & (yy < 0.92 * s)
        roof = (yy > 0.18 * s) & (yy < 0.45 * s) & (
            np.abs(xx - cx) < (yy - 0.18 * s) * 1.2)
        img[body] = (0.75, 0.6, 0.45, 1.0)
        img[roof] = (0.6, 0.2, 0.15, 1.0)
    else:
        raise ValueError(f"unknown stamp {name!r}")
    return img


STAMP_NAMES = ("sun", "moon", "tree", "house")


def place_stamp(image: np.ndarray, stamp: np.ndarray, x: int, y: int,
                scale: float = 1.0) -> np.ndarray:
    """Alpha-composite ``stamp`` centered at (x, y) onto a copy of
    ``image`` ([H, W, 3] float), like the reference's drawPixmap-centered
    placement (canvas.py:292). Off-canvas parts are clipped."""
    sh = max(1, int(round(stamp.shape[0] * scale)))
    sw = max(1, int(round(stamp.shape[1] * scale)))
    # nearest-neighbor resize of the stamp
    ri = (np.arange(sh) * stamp.shape[0] / sh).astype(int)
    ci = (np.arange(sw) * stamp.shape[1] / sw).astype(int)
    st = stamp[ri][:, ci]
    out = image.copy()
    H, W = image.shape[:2]
    y0, x0 = y - sh // 2, x - sw // 2
    sy0, sx0 = max(0, -y0), max(0, -x0)
    dy0, dx0 = max(0, y0), max(0, x0)
    dy1, dx1 = min(H, y0 + sh), min(W, x0 + sw)
    if dy1 <= dy0 or dx1 <= dx0:
        return out
    patch = st[sy0:sy0 + dy1 - dy0, sx0:sx0 + dx1 - dx0]
    a = patch[..., 3:4]
    out[dy0:dy1, dx0:dx1] = a * patch[..., :3] + (1 - a) * out[dy0:dy1,
                                                               dx0:dx1]
    return out


class UndoStack:
    """Bounded snapshot stack backing the demo's undo button / Ctrl-Z
    (the reference canvas keeps a QImage history; same contract)."""

    def __init__(self, limit: int = 20):
        self.limit = limit
        self._stack: List[np.ndarray] = []

    def push(self, image: np.ndarray) -> None:
        self._stack.append(np.array(image, copy=True))
        if len(self._stack) > self.limit:
            self._stack.pop(0)

    def pop(self) -> Optional[np.ndarray]:
        return self._stack.pop() if self._stack else None

    def __len__(self) -> int:
        return len(self._stack)
