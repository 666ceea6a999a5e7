"""Edit masks and their pyramids, the rules of lmxyy/sige ``sige/utils.py``
(``dilate_mask``, ``downsample_mask``) as the runners of the program
apply them: the benchmark builds every mask pyramid it hands the program
and the reference."""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

IntPair = Tuple[int, int]


def _pair(v) -> IntPair:
    if isinstance(v, (int, np.integer)):
        return (int(v), int(v))
    return (int(v[0]), int(v[1]))


def dilate_mask(mask: np.ndarray, dilation: Union[int, IntPair]) -> np.ndarray:
    """Cross-shaped dilation: the union of the mask's vertical shifts up to
    ``dh`` and its horizontal shifts up to ``dw``, both of the original
    mask (the reference's second loop reads ``mask``, not the result)."""
    dh, dw = _pair(dilation)
    mask = np.asarray(mask, bool)
    out = mask.copy()
    for i in range(1, dh + 1):
        out[:-i] |= mask[i:]
        out[i:] |= mask[:-i]
    for i in range(1, dw + 1):
        out[:, :-i] |= mask[:, i:]
        out[:, i:] |= mask[:, :-i]
    return out


def _bilinear(x: np.ndarray, out_hw: IntPair) -> np.ndarray:
    """Half-pixel-centre bilinear resize (``F.interpolate(mode="bilinear",
    align_corners=False)``) of a 2-D float array."""
    H, W = x.shape

    def axis(n_in, n_out):
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        src = np.clip(src, 0.0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        return lo, np.minimum(lo + 1, n_in - 1), src - lo

    h_lo, h_hi, h_f = axis(H, out_hw[0])
    w_lo, w_hi, w_f = axis(W, out_hw[1])
    x = x.astype(np.float64)
    top = x[h_lo][:, w_lo] * (1 - w_f) + x[h_lo][:, w_hi] * w_f
    bot = x[h_hi][:, w_lo] * (1 - w_f) + x[h_hi][:, w_hi] * w_f
    return (top * (1 - h_f)[:, None] + bot * h_f[:, None]).astype(np.float32)


def downsample_mask(mask: np.ndarray, min_res: Union[int, IntPair] = 4,
                    dilation: Union[int, IntPair] = 1,
                    threshold: float = 0.3,
                    eps: float = 1e-3) -> Dict[IntPair, np.ndarray]:
    """{(h, w): bool [h, w]} halving from the mask's size until both sides
    are below ``min_res``: each level the bilinear downsample of the float
    mask thresholded at min(threshold, its max - eps), then dilated."""
    mask = np.asarray(mask, bool)
    H, W = mask.shape
    min_h, min_w = _pair(min_res)
    out: Dict[IntPair, np.ndarray] = {}
    interp = mask.astype(np.float32)
    h, w = H, W
    while True:
        t = min(threshold, float(interp.max()) - eps)
        out[(h, w)] = dilate_mask(interp > t, dilation)
        h //= 2
        w //= 2
        if h < min_h and w < min_w:
            break
        interp = _bilinear(interp, (h, w))
    return out
