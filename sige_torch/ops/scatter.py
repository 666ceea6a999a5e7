"""Scatter ops, written as deterministic gathers through host-planned
source-index maps.

The reference engine writes conv-output tiles into a clone of the cached
full-resolution activation, racing benignly on tile overlap
(reference: sige/cpu/scatter.cpp, sige/cuda/scatter_kernel.cu). As in
``sige_tpu.ops.scatter``, a per-pixel flat source index into the
tile-pixel axis is planned once per mask on the host
(:func:`sige_torch.core.scatter_map.build_src_map`), and every scatter
becomes "each output pixel reads from its source tile pixel, else the
cache": one ``index_select`` plus a select, fully deterministic (source =
highest covering tile, the reference's sequential last-writer-wins).

The plan's lookups lead with the installed plan's S >= 1 sessions (S
sessions of B samples run as one batch of S*B; one session's plan is a
stack of one): ``[S, BH, BW]`` boxes, ``[S, N]`` re-gather sources, and
bbox origins an int64 device tensor ``[S, 2]``. Each session's samples
read their own lookups, and the boxes are read and written at their
session's origin through :func:`~sige_torch.ops.sessions.crop_sessions`
and :func:`~sige_torch.ops.sessions.paste_sessions`, the origin clamped
so the box fits inside the map, exactly as ``jax.lax.dynamic_slice`` and
``dynamic_update_slice`` clamp their start indices.

A cache may be stored in a narrower dtype than the tiles
(``SIGEModel(cache_dtype=)``): every op computes in the tiles' dtype, its
copy of the cache made in that dtype (the cast rides in the copy) and its
selects promoting, so fresh values are never rounded to the cache's.

Ops:
  * :func:`scatter_tiles` / :func:`scatter_tiles_box` — plain scatter into
    a cached map, optional residual added at covered pixels only
    (reference: sige/cpu/scatter.cpp:4-41); the box form also turns a
    tile-resident state back into a full map.
  * :func:`calibrate_residual` — ``out += x_tile - cached`` over a second
    (shortcut) tile set (reference: sige/cpu/scatter.cpp:43-76).
  * :func:`scatter_with_block_residual_box` — the two combined, for
    resblocks whose main/shortcut paths use different block sizes
    (reference: sige/cpu/scatter.cpp:115-135).
  * :func:`scatter_gather_tiles` — fused scatter->re-gather between the
    two convs of a resblock, never materializing the full map
    (reference: sige/cpu/scatter_gather.cpp:5-57).
  * :func:`scatter_gather_residual_tiles` — a resblock's residual join
    evaluated at the gather positions, the step of a tile-resident chain
    (the VAE's ``tile_chain``).
  * :func:`materialize_tiles` — a tile-resident state back to a full map.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.geometry import BlockGeometry
from .gather import apply_epilogue, broadcast_param, take_sessions
from .sessions import crop_sessions, paste_sessions


def _long(t, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device).to(torch.int64)


def _take(t: torch.Tensor, src, device) -> torch.Tensor:
    """``t[:, max(src, 0)]`` over the flat pixel axis of [B, P, C]."""
    return t.index_select(1, _long(src, device).reshape(-1).clamp_min(0))


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def scatter_tiles(
    tiles: torch.Tensor,
    cache: torch.Tensor,
    src_map,
    geom: BlockGeometry,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scatter conv-output tiles over a cached full map.

    Args:
      tiles: [B * K, R, S, C] conv-output tile batch.
      cache: [B, H, W, C] cached full-map activation (original image).
      src_map: [H, W] flat tile-pixel source index (-1 = keep cache).
      geom: the paired gather's geometry (tile extent R, S).
      residual: optional [B, H, W, C]-broadcastable residual, added at
        covered pixels only.

    Returns: [B, H, W, C] updated full map.
    """
    B, H, W, C = cache.shape
    R, S = geom.out_tile_size
    K = tiles.shape[0] // B
    src = _long(src_map, cache.device)
    fresh = _take(tiles.reshape(B, K * R * S, C), src,
                  cache.device).reshape(B, H, W, C)
    if residual is not None:
        fresh = fresh + broadcast_param(residual)
    return torch.where((src >= 0)[None, :, :, None], fresh, cache)


def scatter_tiles_box(
    tiles: torch.Tensor,
    cache: torch.Tensor,
    src_box,
    origin: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bounding-box form of :func:`scatter_tiles`: the planner crops the
    source map to the bbox of the covered pixels (``src_box`` [S, BH, BW]
    at ``origin`` [S, 2]), so the join costs the edit's bbox plus one copy
    of the cache, not a gather over the whole canvas. ``tiles`` is
    [S*B * K, ..., C]; with a tile-resident state and its pixel ->
    gather-position box (``pixbox_*``) it is the bbox form of
    :func:`materialize_tiles`."""
    N, H, W, C = cache.shape
    box = _long(src_box, cache.device)
    S, BH, BW = box.shape
    fresh = take_sessions(tiles.reshape(N, -1, C), box.reshape(S, -1)
                          ).reshape(N, BH, BW, C)
    if residual is not None:
        r = broadcast_param(residual)
        if r.shape[1] == H and r.shape[2] == W:
            r = crop_sessions(r, origin, BH, BW, clamp=True)
        fresh = fresh + r
    return paste_sessions(cache, fresh, origin, box >= 0, clamp=True)


def scatter_with_block_residual_box(
    main_tiles: torch.Tensor,
    cache_out: torch.Tensor,
    shortcut_tiles: torch.Tensor,
    cache_residual: torch.Tensor,
    main_src_box,
    main_origin: torch.Tensor,
    shortcut_src_box,
    shortcut_origin: torch.Tensor,
) -> torch.Tensor:
    """Residual join when main and shortcut paths were gathered with
    different block sizes, as two staged box updates.

    ``cache_out`` caches the full-mode sum (main + shortcut);
    ``cache_residual`` caches the full-mode shortcut alone. Main-covered
    pixels get fresh-main + cached-shortcut; shortcut-covered pixels are
    then corrected by (fresh-shortcut - cached-shortcut).
    """
    N, H, W, C = cache_out.shape
    dev = cache_out.device
    mbox, sbox = _long(main_src_box, dev), _long(shortcut_src_box, dev)
    S, MH, MW = mbox.shape
    fresh_m = take_sessions(main_tiles.reshape(N, -1, C), mbox.reshape(S, -1)
                            ).reshape(N, MH, MW, C)
    y1_m = crop_sessions(cache_residual, main_origin, MH, MW, clamp=True)
    out = paste_sessions(cache_out, fresh_m + y1_m, main_origin, mbox >= 0,
                         clamp=True)
    _, SH, SW = sbox.shape
    fresh_s = take_sessions(shortcut_tiles.reshape(N, -1, C),
                            sbox.reshape(S, -1)).reshape(N, SH, SW, C)
    y1_s = crop_sessions(cache_residual, shortcut_origin, SH, SW, clamp=True)
    base = crop_sessions(out, shortcut_origin, SH, SW, clamp=True)
    delta = torch.where(sbox[:, None, :, :, None] >= 0,
                        (fresh_s - y1_s).unflatten(0, (S, -1)),
                        _zero(base)).flatten(0, 1)
    return paste_sessions(out, base + delta, shortcut_origin, clamp=True)


def calibrate_residual(
    out: torch.Tensor,
    tiles: torch.Tensor,
    cached: torch.Tensor,
    src_map,
    geom: BlockGeometry,
) -> torch.Tensor:
    """``out += tile_value - cached`` over the covered pixels of a second
    tile set (reference: sige/cpu/scatter.cpp:43-76)."""
    B, H, W, C = out.shape
    R, S = geom.out_tile_size
    K = tiles.shape[0] // B
    src = _long(src_map, out.device)
    fresh = _take(tiles.reshape(B, K * R * S, C), src,
                  out.device).reshape(B, H, W, C)
    delta = torch.where((src >= 0)[None, :, :, None], fresh - cached,
                        _zero(out))
    return out + delta


def scatter_gather_tiles(
    tiles: torch.Tensor,
    cache: torch.Tensor,
    sg_src,
    sg_flat,
    geom: BlockGeometry,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Fused scatter->re-gather between the two convs of a resblock.

    Both convs share one Gather, so ``tiles`` (conv1 outputs) and the
    re-gathered output blocks use the *same* index buffer. Each
    re-gathered pixel reads from its source fresh tile pixel
    (``sg_src >= 0``), from the cached full map (``sg_src == -1``), or is
    exact zero (``sg_src == -2``: out of bounds / dead tile), then the
    folded-norm epilogue applies (reference: sige/cpu/scatter_gather.cpp).

    Args:
      tiles: [B * K, R, S, C] conv1-output tile batch (B = S * samples
        per session).
      cache: [B, H, W, C] cached conv1 full map.
      sg_src / sg_flat: [S, K * bh * bw] host-planned lookups
        (:func:`~sige_torch.core.scatter_map.build_sg_sources`).

    Returns: [B * K, bh, bw, C] tile batch feeding conv2.
    """
    return _sg(tiles, cache, None, sg_src, sg_flat, geom, scale, shift,
               activation, activation_first, True)


def _sg(tiles, cache, res_tiles, sg_src, sg_flat, geom, scale, shift,
        activation, activation_first, spatial_params):
    """The body of :func:`scatter_gather_tiles` (``res_tiles`` None) and
    :func:`scatter_gather_residual_tiles`: [S, M] lookups."""
    N, H, W, C = cache.shape
    bh, bw = geom.block_size
    dev = cache.device
    src = _long(sg_src, dev)
    flat = _long(sg_flat, dev)
    S, M = src.shape
    fresh = take_sessions(tiles.reshape(N, -1, C), src)          # [N, M, C]
    if res_tiles is not None:
        fresh = fresh + res_tiles.reshape(N, M, C)
    cached = take_sessions(cache.reshape(N, H * W, C), flat)

    def split(t):
        return t.unflatten(0, (S, -1))

    z = torch.where(src[:, None, :, None] >= 0, split(fresh), split(cached))

    def gather_param(p):
        p = broadcast_param(p)
        if p is None:
            return None
        if p.shape[1] == 1 and p.shape[2] == 1:
            if p.shape[0] == 1:  # one row for every sample
                return p.reshape(1, 1, 1, p.shape[3])
            return split(p.reshape(p.shape[0], 1, p.shape[3]))
        if not spatial_params:
            raise ValueError("per-channel epilogue params expected")
        return split(take_sessions(p.reshape(p.shape[0], -1, p.shape[3]),
                                   flat))

    z = apply_epilogue(z, gather_param(scale), gather_param(shift),
                       activation, activation_first)
    z = torch.where(src[:, None, :, None] >= -1, z, _zero(z))
    return z.reshape(N * (M // (bh * bw)), bh, bw, C)


def materialize_tiles(
    tile_state: torch.Tensor,
    cache: torch.Tensor,
    pix_src,
    geom: BlockGeometry,
) -> torch.Tensor:
    """Turn a tile-resident state [B * K, bh, bw, C] back into a full map:
    ``pix_src`` maps each output pixel to a covering gather-position pixel
    (-1 uncovered, which keeps the cached value)."""
    B, H, W, C = cache.shape
    bh, bw = geom.block_size
    K = tile_state.shape[0] // B
    src = _long(pix_src, cache.device)
    fresh = _take(tile_state.reshape(B, K * bh * bw, C), src,
                  cache.device).reshape(B, H, W, C)
    return torch.where((src >= 0)[None, :, :, None], fresh, cache)


def scatter_gather_residual_tiles(
    tiles: torch.Tensor,
    cache: torch.Tensor,
    res_tiles: torch.Tensor,
    sg_src,
    sg_flat,
    geom: BlockGeometry,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """A resblock's residual join evaluated at the gather positions (the
    step of a tile-resident chain): for each gather-position pixel

        z = covered ? conv2_tile_px + residual_tile_px : cached_px

    then the epilogue (per-channel ``scale`` / ``shift`` [B, C] and the
    activation); out-of-bounds pixels are exact zero. The residual arrives
    as tiles at the same gather positions (the chain's carried state), so
    the full map never materializes.

    Args:
      tiles: [B * K, R, S, C] conv2-output tile batch.
      cache: [B, H, W, C] the join's cached full-mode output.
      res_tiles: [B * K, bh, bw, C] the residual at the gather positions.
      sg_src / sg_flat: [S, K * bh * bw] host-planned lookups
        (:func:`~sige_torch.core.scatter_map.build_sg_sources`).

    Returns: [B * K, bh, bw, C], the block's output at the gather
    positions.
    """
    return _sg(tiles, cache, res_tiles, sg_src, sg_flat, geom, scale, shift,
               activation, activation_first, False)
