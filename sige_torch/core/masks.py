"""Difference-mask pipeline: edit mask -> per-resolution mask pyramid ->
active tile indices.

This is the *planning* side of the engine. It runs host-side in numpy once
per edit (the reference also runs it on host via torch CPU ops,
reference: sige/utils.py). The hot denoising loop only consumes the
fixed-capacity index buffers this module produces; capacities are rounded
up to buckets so repeated edits of similar size share buffer shapes.

Index semantics match the reference exactly (reference: sige/utils.py:8-37):
the mask is padded by ``offset`` on the top/left and ``block_size`` on the
bottom/right, max-pooled with window ``block_size`` / stride
``block_stride``, and every active pooled cell maps back to a tile top-left
``cell * block_stride - offset`` in (possibly negative) padded input
coordinates.

The port's copy of ``sige_tpu.core.masks``: 2-D dilation and the tile
reduction run in the native host planner (:mod:`sige_torch.native`) when
it is in use, and else in numpy, with the same arrays bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from .. import native
from .geometry import BlockGeometry

IntPair = Tuple[int, int]

#: Tile index used to pad fixed-capacity index buffers. Chosen so that a
#: gather at this index reads far out of bounds (-> zeros) on any feature
#: map the engine will ever see; execution-side ops additionally mask
#: padded slots via the live-tile count.
SENTINEL: int = -(2**15)


def _pair(v) -> IntPair:
    if isinstance(v, (int, np.integer)):
        return (int(v), int(v))
    return (int(v[0]), int(v[1]))


def compute_difference_mask(a, b, eps: float = 2e-2) -> np.ndarray:
    """Boolean [H, W] mask of where two images differ by more than eps.

    Accepts [H, W], [H, W, C] or [1, H, W, C] arrays (NHWC; the reference
    uses NCHW, reference: sige/utils.py:74-85).
    """
    a, b = np.asarray(a), np.asarray(b)
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32)) > eps
    if diff.ndim == 2:
        return diff
    if diff.ndim == 3:  # [H, W, C]
        return np.any(diff, axis=-1)
    if diff.ndim == 4:  # [1, H, W, C]
        if diff.shape[0] != 1:
            raise ValueError("difference mask expects batch size 1")
        return np.any(diff[0], axis=-1)
    raise ValueError(f"unsupported mask rank {diff.ndim}")


def dilate_mask(mask, dilation: Union[int, IntPair]) -> np.ndarray:
    """Cross-shaped binary dilation via shift-OR: the union of the mask's
    vertical shifts (up to ``dh``) and horizontal shifts (up to ``dw``),
    both taken from the ORIGINAL mask — NOT a separable box dilation. This
    matches the reference exactly (reference: sige/utils.py:40-71, where
    the second axis loop reads ``mask``, not ``ret``). Uses the native
    planner for a 2-D mask when it is in use."""
    dh, dw = _pair(dilation)
    mask = np.asarray(mask).astype(bool)
    if dh <= 0 and dw <= 0:
        return mask
    if mask.ndim == 2 and native.available():
        return native.dilate_mask(mask, (dh, dw))
    out = mask.copy()
    for i in range(1, dh + 1):
        out[:-i] |= mask[i:]
        out[i:] |= mask[:-i]
    for i in range(1, dw + 1):
        out[:, :-i] |= mask[:, i:]
        out[:, i:] |= mask[:, :-i]
    return out


def _bilinear_resize(x: np.ndarray, out_hw: IntPair) -> np.ndarray:
    """Bilinear resize of a 2-D float array with half-pixel centers
    (matches torch ``F.interpolate(mode="bilinear", align_corners=False)``
    used by the reference at sige/utils.py:117)."""
    H, W = x.shape
    oh, ow = out_hw

    def axis_coords(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        src = np.clip(src, 0.0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = src - lo
        return lo, hi, frac.astype(np.float64)

    h_lo, h_hi, h_f = axis_coords(H, oh)
    w_lo, w_hi, w_f = axis_coords(W, ow)
    x = x.astype(np.float64)
    top = x[h_lo][:, w_lo] * (1 - w_f) + x[h_lo][:, w_hi] * w_f
    bot = x[h_hi][:, w_lo] * (1 - w_f) + x[h_hi][:, w_hi] * w_f
    out = top * (1 - h_f)[:, None] + bot * h_f[:, None]
    return out.astype(np.float32)


def downsample_mask(
    mask,
    min_res: Union[int, IntPair] = 4,
    dilation: Union[int, IntPair] = 1,
    threshold: float = 0.3,
    eps: float = 1e-3,
) -> Dict[IntPair, np.ndarray]:
    """Build the per-resolution mask pyramid keyed by (h, w), halving until
    below ``min_res`` (reference: sige/utils.py:88-118).

    Each level thresholds the bilinearly-downsampled float mask at
    ``min(threshold, level_max - eps)`` — so at least one pixel survives —
    then box-dilates it.
    """
    mask = np.asarray(mask).astype(bool)
    if mask.ndim != 2:
        raise ValueError("downsample_mask expects a 2-D mask")
    H, W = mask.shape
    min_h, min_w = _pair(min_res)

    masks: Dict[IntPair, np.ndarray] = {}
    interp = mask.astype(np.float32)
    h, w = H, W
    while True:
        t = min(threshold, float(interp.max()) - eps)
        level = dilate_mask(interp > t, dilation)
        masks[(h, w)] = level
        h //= 2
        w //= 2
        if h < min_h and w < min_w:
            break
        interp = _bilinear_resize(interp, (h, w))
    return masks


def _max_pool_bool(mask: np.ndarray, window: IntPair, stride: IntPair) -> np.ndarray:
    """Max-pool a boolean array. Window sizes are tiny (<= block size), so a
    shift-OR over window offsets is fast enough for planning."""
    H, W = mask.shape
    oh = (H - window[0]) // stride[0] + 1
    ow = (W - window[1]) // stride[1] + 1
    out = np.zeros((oh, ow), dtype=bool)
    for dh in range(window[0]):
        for dw in range(window[1]):
            out |= mask[dh : dh + (oh - 1) * stride[0] + 1 : stride[0],
                        dw : dw + (ow - 1) * stride[1] + 1 : stride[1]]
    return out


def reduce_mask(mask, geom: BlockGeometry, verbose: bool = False) -> np.ndarray:
    """Reduce a boolean [H, W] mask to int32 [N, 2] active tile top-left
    indices in padded input coordinates (reference: sige/utils.py:8-37)."""
    mask = np.asarray(mask).astype(bool)
    bh, bw = geom.block_size
    sh, sw = geom.block_stride
    ph, pw = geom.offset
    padded = np.zeros((mask.shape[0] + ph + bh, mask.shape[1] + pw + bw), dtype=bool)
    padded[ph : ph + mask.shape[0], pw : pw + mask.shape[1]] = mask
    pooled = _max_pool_bool(padded, (bh, bw), (sh, sw))
    ys, xs = np.nonzero(pooled)
    indices = np.stack([ys * sh - ph, xs * sw - pw], axis=-1).astype(np.int32)
    if verbose:
        n, total = indices.shape[0], pooled.size
        print(f"Block Sparsity: {n}/{total}={100.0 * n / total:.2f}%")
    return indices


def round_to_bucket(n: int, minimum: int = 8) -> int:
    """Round a tile count up to a capacity bucket: quarter-steps between
    powers of two (…, 512, 640, 768, 896, 1024, 1280, …), so padded
    capacity wastes at most 25%."""
    n = max(int(n), 1)
    if n <= minimum:
        return minimum
    step = max((1 << (int(n - 1).bit_length() - 1)) // 4, minimum)
    return -(-n // step) * step


def grid_tiles(shape: IntPair, geom: BlockGeometry) -> int:
    """Total candidate tile positions for a mask of ``shape`` — the hard
    capacity ceiling (a bucket above it would pad tile buffers past the
    canvas itself, making "sparse" compute exceed dense at coarse
    resolutions)."""
    bh, bw = geom.block_size
    sh, sw = geom.block_stride
    ph, pw = geom.offset
    gh = (shape[0] + ph + bh - bh) // sh + 1
    gw = (shape[1] + pw + bw - bw) // sw + 1
    return gh * gw


def reduce_mask_padded(
    mask,
    geom: BlockGeometry,
    capacity: Optional[int] = None,
    bucket_min: int = 8,
) -> Tuple[np.ndarray, int]:
    """Like :func:`reduce_mask`, but returns a fixed-capacity buffer
    ``(indices [K, 2] int32, count)`` padded with :data:`SENTINEL` rows.

    ``capacity`` pins K explicitly; otherwise K = next bucket above the live
    count, capped at the canvas's total tile positions. Raises if the live
    count exceeds an explicit capacity. Counts and reduces in the native
    planner when it is in use.
    """
    mask = np.asarray(mask).astype(bool)
    use_native = native.available()
    if use_native:
        n = native.count_tiles(mask, geom)
    else:
        indices = reduce_mask(mask, geom)
        n = indices.shape[0]
    if capacity is None:
        capacity = min(round_to_bucket(n, bucket_min),
                       grid_tiles(mask.shape, geom))
    if n > capacity:
        raise ValueError(f"active tiles {n} exceed capacity {capacity}")
    if use_native:
        return native.reduce_mask_padded(mask, geom, capacity, SENTINEL)
    out = np.full((capacity, 2), SENTINEL, dtype=np.int32)
    out[:n] = indices
    return out, n
