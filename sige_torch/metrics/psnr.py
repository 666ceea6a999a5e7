"""PSNR, optionally restricted to a mask region — the port of
``sige_tpu.metrics.psnr`` (reference: diffusion/metrics/psnr_score.py:12-59
uses skimage PSNR with an optional edited-region restriction)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, mask: Optional[np.ndarray] = None,
         data_range: float = 255.0) -> float:
    """PSNR between uint8-range images [H, W, C], in float64. ``mask``
    ([H, W] bool) restricts the MSE to the masked pixels (the reference's
    ``--mask`` / edited-region mode); equal images give ``inf``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    err = (a - b) ** 2
    if mask is not None:
        err = err[np.asarray(mask, bool)]
    mse = err.mean()
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
