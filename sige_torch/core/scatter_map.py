"""Scatter ownership maps.

The reference engine scatters conv-output tiles into a cloned cache with
last-writer-wins races on tile overlap (benign there because overlapping
tiles carry identical values; reference: sige/cuda/scatter_kernel.cu:37-43,
sige/cpu/scatter_gather.cpp:58-84 ``get_scatter_map``).

Here the dataflow is inverted: a host-side planning step assigns every
output pixel its *owning* tile (the highest-numbered covering tile — the
same winner as the reference's sequential CPU loop) and resolves it all
the way to a flat tile-pixel source index, so scatter becomes a
deterministic, fully-parallel gather "read your pixel from its source
tile pixel, else from the cache". The source maps serve plain scatter,
the fused scatter-gather, and residual calibration.

The port's copy of ``sige_tpu.core.scatter_map``: the source maps are
built by the native host planner (:mod:`sige_torch.native`) when it is in
use, and else in numpy, with the same arrays bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native
from .geometry import BlockGeometry


def build_owner_map(
    indices: np.ndarray,
    count: Optional[int],
    geom: BlockGeometry,
    out_hw: Tuple[int, int],
) -> np.ndarray:
    """Build the int32 [H, W] ownership map in conv-output coordinates.

    ``owner[h, w]`` is the index (into ``indices``) of the highest live tile
    whose output extent covers (h, w), or -1 if no tile covers it.

    Args:
      indices: [K, 2] int32 tile top-lefts in padded *input* coordinates
        (possibly SENTINEL-padded).
      count: number of live rows in ``indices`` (None = all).
      geom: block geometry of the gather feeding the scattered conv.
      out_hw: (H, W) of the conv output / cache.
    """
    H, W = out_hw
    owner = np.full((H, W), -1, dtype=np.int32)
    indices = np.asarray(indices)
    n = indices.shape[0] if count is None else int(count)
    if n == 0:
        return owner
    R, S = geom.out_tile_size
    sh, sw = geom.conv_stride
    oh, ow = geom.offset

    ib = np.arange(n, dtype=np.int32)
    bi_h = (oh + indices[:n, 0].astype(np.int64)) // sh  # [n]
    bi_w = (ow + indices[:n, 1].astype(np.int64)) // sw
    hh = bi_h[:, None, None] + np.arange(R, dtype=np.int64)[None, :, None]  # [n,R,1]
    ww = bi_w[:, None, None] + np.arange(S, dtype=np.int64)[None, None, :]  # [n,1,S]
    hh = np.broadcast_to(hh, (n, R, S))
    ww = np.broadcast_to(ww, (n, R, S))
    valid = (hh >= 0) & (hh < H) & (ww >= 0) & (ww < W)
    flat = (hh * W + ww)[valid]
    tile_of = np.broadcast_to(ib[:, None, None], (n, R, S))[valid]
    np.maximum.at(owner.reshape(-1), flat, tile_of)
    return owner


def build_src_map(
    indices: np.ndarray,
    count: Optional[int],
    geom: BlockGeometry,
    out_hw: Tuple[int, int],
) -> np.ndarray:
    """Per-pixel flat *tile-pixel* source index, the device-ready form of
    the ownership map: ``src[h, w] = (owner * R + ih) * S + iw`` for
    covered pixels, -1 otherwise. Built by the native planner when it is
    in use."""
    if native.available():
        n = np.asarray(indices).shape[0] if count is None else int(count)
        return native.build_src_map(indices, n, geom, out_hw)
    H, W = out_hw
    owner = build_owner_map(indices, count, geom, out_hw)
    R, S = geom.out_tile_size
    sh, sw = geom.conv_stride
    oh, ow = geom.offset
    oc = np.maximum(owner, 0).astype(np.int64)
    idx = np.asarray(indices, np.int64)
    bi_h = (oh + idx[oc, 0]) // sh
    bi_w = (ow + idx[oc, 1]) // sw
    row = np.arange(H, dtype=np.int64)[:, None]
    col = np.arange(W, dtype=np.int64)[None, :]
    ih = np.clip(row - bi_h, 0, R - 1)
    iw = np.clip(col - bi_w, 0, S - 1)
    src = (oc * R + ih) * S + iw
    return np.where(owner >= 0, src, -1).astype(np.int32)


def build_sg_sources(
    indices: np.ndarray,
    count: Optional[int],
    geom: BlockGeometry,
    out_hw: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-precomputed lookups for the fused scatter->re-gather.

    For each re-gathered tile pixel (K * bh * bw, same index buffer as the
    source tiles — reference: sige/nn/scatter_gather.py):
      * ``sg_src``: flat tile-pixel source index, or -1 to read the cache,
        or -2 for out-of-bounds/dead (exact zero);
      * ``sg_flat``: flat cache pixel index (clamped).

    Built by the native planner when it is in use.
    """
    if native.available():
        n = np.asarray(indices).shape[0] if count is None else int(count)
        return native.build_sg_sources(indices, n, geom, out_hw)
    H, W = out_hw
    src_map = build_src_map(indices, count, geom, out_hw)
    bh, bw = geom.block_size
    K = np.asarray(indices).shape[0]
    n = K if count is None else int(count)
    idx = np.asarray(indices, np.int64)
    rows = idx[:, 0:1, None] + np.arange(bh, dtype=np.int64)[None, :, None]
    cols = idx[:, 1:2, None].transpose(0, 2, 1) + np.arange(bw, dtype=np.int64)[None, None, :]
    rows = np.broadcast_to(rows, (K, bh, bw))
    cols = np.broadcast_to(cols, (K, bh, bw))
    live = (np.arange(K) < n)[:, None, None]
    inb = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W) & live
    rc = np.clip(rows, 0, H - 1)
    cc = np.clip(cols, 0, W - 1)
    flat = (rc * W + cc).reshape(-1).astype(np.int32)
    src = src_map.reshape(-1)[flat]
    sg_src = np.where(inb.reshape(-1), src, -2).astype(np.int32)
    return sg_src, flat


def bbox_of_map(m: np.ndarray, mult: int = 32, size=None):
    """Crop a source map to the bounding box of its covered (>= 0) pixels.

    Returns ``(origin, box)`` with ``origin`` int32[2] = (r0, c0) and
    ``box = m[r0:r0+BH, c0:c0+BW]``; BH/BW are rounded up to multiples of
    ``mult`` (bucketing, so edits of similar size share box shapes) and
    clamped to the map. An empty map yields a minimal all-(-1) box.

    ``size`` pins (BH, BW) explicitly (clamped to the map). Raises
    ValueError when the covered extent outgrows a pinned size (the caller
    falls back to a fresh bucket). Area a pinned box covers beyond the
    tight bbox is all -1 (keep-cached), which the scatter forms already
    treat as a no-op.
    """
    H, W = m.shape
    cov = m >= 0
    rows = np.flatnonzero(cov.any(axis=1))
    cols = np.flatnonzero(cov.any(axis=0))
    if rows.size == 0:
        r_lo = r_hi = c_lo = c_hi = 0
    else:
        r_lo, r_hi = int(rows[0]), int(rows[-1]) + 1
        c_lo, c_hi = int(cols[0]), int(cols[-1]) + 1

    def fit(lo, hi, limit, forced):
        if forced is not None:
            s = min(int(forced), limit)
            if hi - lo > s:
                raise ValueError(
                    f"bbox extent {hi - lo} exceeds pinned box size {s}")
        else:
            s = min(max(-(-(hi - lo) // mult) * mult, mult), limit)
        return min(lo, limit - s), s

    r0, bh = fit(r_lo, r_hi, H, size[0] if size is not None else None)
    c0, bw = fit(c_lo, c_hi, W, size[1] if size is not None else None)
    origin = np.array([r0, c0], np.int32)
    return origin, np.ascontiguousarray(m[r0:r0 + bh, c0:c0 + bw])


def gather_position_geom(geom: BlockGeometry) -> BlockGeometry:
    """Pseudo-geometry whose conv-output tiles ARE the gather blocks:
    origins = raw indices, extent = block size. Fed to
    :func:`build_src_map` it gives the pixel -> gather-position map that
    materializes a tile-resident chain."""
    return BlockGeometry(
        block_size=geom.block_size,
        block_stride=geom.block_stride,
        offset=(0, 0),
        kernel_size=(1, 1),
        conv_stride=(1, 1),
    )
