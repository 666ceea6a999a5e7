"""Window-layout ops: one contiguous crop window per layer instead of tiles.

The port of ``sige_tpu.ops.window``. For a compact edit the active tiles
form a (nearly) dense sub-grid, so each layer can instead extract ONE
axis-aligned window of its input (the bucketed canonical window plus the
conv's halo), run the dense conv on it, and overlay the result on the
cache. Coverage masks planned on the host keep the tile engine's
fresh-vs-cached semantics exactly on the original input.

Plan products lead with the installed plan's S >= 1 sessions (S sessions
of B samples run as one batch of S*B, sample ``s*B + b`` under session
s; one session's plan is a stack of one): window metas and origins are
int64 device tensors ``[S, k]``, coverage and edge masks bool ``[S, h,
w]``. Every op builds on :func:`~sige_torch.ops.sessions.crop_sessions`
and :func:`~sige_torch.ops.sessions.paste_sessions` (a hand-written
kernel each on the card), which read each sample's window at its
session's origin.

Border windows: ``sige_tpu`` slices at a clamped start, rolls the window
back into alignment and zeroes the out-of-image ring with the planned
edge mask. Here the crop reads zero outside the image, which gives the
same values, also for an extent wider than the canvas. A meta is the
planner's 2-form ``(r, c)`` (the window is fully in image, so the edge
mask is skipped) or 4-form ``(clamped_r, clamped_c, roll_r, roll_c)``;
the window's virtual origin is ``clamped - roll``.

No op writes into its inputs: caches hold the full pass's activations
themselves, so every overlay writes into a copy. A cache may be stored
in a narrower dtype than the fresh values (``SIGEModel(cache_dtype=)``):
the overlay's copy is made in the fresh values' dtype (the cast rides in
the copy), and the elementwise joins promote, so fresh windows are never
rounded to the cache's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .gather import apply_epilogue, broadcast_param
from .sessions import (cov_where, crop_sessions, paste_sessions,
                       virtual_origin)

IntPair = Tuple[int, int]


def is_fast_meta(meta: torch.Tensor) -> bool:
    """The 2-form meta: every session's window fully inside the image."""
    return meta.shape[-1] == 2


def window_extent(mask: torch.Tensor) -> IntPair:
    """(h, w) of a coverage or edge mask [S, h, w]."""
    return tuple(mask.shape[-2:])


def _epilogue(z, edge, scale, shift, activation, activation_first):
    """The fused norm epilogue on windows ``z`` and the out-of-image ring
    re-zeroed where ``edge`` ([S, EH, EW]; None for in-image windows) is
    False, in one pass (a crop at the window's own origin)."""
    if edge is None and scale is None and shift is None \
            and activation == "identity":
        return z
    EH, EW = z.shape[1:3]
    return crop_sessions(z, (0, 0), EH, EW, edge, scale, shift, activation,
                         activation_first)


def window_epilogue(z, edge, scale=None, shift=None,
                    activation: str = "identity",
                    activation_first: bool = False):
    """Epilogue for callers that extend several windows and concatenate
    them before the fused norm (the U-Net's skip joins): ``scale*x+shift``
    and the activation, then the out-of-image ring re-zeroed (``edge``
    [S, EH, EW]; None for in-image windows, whose epilogue runs as
    PyTorch ops)."""
    if edge is None:
        return apply_epilogue(z, broadcast_param(scale),
                              broadcast_param(shift), activation,
                              activation_first)
    return _epilogue(z, edge, scale, shift, activation, activation_first)


def _ring(meta: torch.Tensor, edge: torch.Tensor):
    """The edge mask a window at ``meta`` needs: None in image."""
    return None if is_fast_meta(meta) else edge


def window_gather(
    x: torch.Tensor,
    meta: torch.Tensor,
    edge: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Window analogue of :func:`~sige_torch.ops.gather.gather_tiles`:
    the conv input window (with halo) of ``x``, the folded-norm epilogue
    fused, the out-of-image ring zero."""
    EH, EW = window_extent(edge)
    return crop_sessions(x, meta, EH, EW, _ring(meta, edge), scale, shift,
                         activation, activation_first)


def window_scatter_gather(
    h_win: torch.Tensor,
    cache: torch.Tensor,
    meta: torch.Tensor,
    edge: torch.Tensor,
    cov: torch.Tensor,
    pad: IntPair,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Window analogue of the fused scatter->re-gather between a
    resblock's two convs: the cached conv1 map gives the halo ring and
    the uncovered pixels, the fresh conv1 window ``h_win`` the covered
    interior. ``pad`` (the conv's padding) is the fresh window's offset
    inside the ring window."""
    EH, EW = window_extent(edge)
    z = paste_sessions(crop_sessions(cache, meta, EH, EW), h_win, pad, cov)
    return _epilogue(z, _ring(meta, edge), scale, shift, activation,
                     activation_first)


def window_slice(x: torch.Tensor, org: torch.Tensor,
                 shape: IntPair) -> torch.Tensor:
    """[S*B, WH, WW, C] in-image window of ``x`` at the origins ``org``
    (clamped so the window fits; canonical windows are always in
    image)."""
    return crop_sessions(x, org, shape[0], shape[1], clamp=True)


def window_scatter(
    h_win: torch.Tensor,
    cache: torch.Tensor,
    org: torch.Tensor,
    cov: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Window analogue of :func:`~sige_torch.ops.scatter.scatter_tiles_box`:
    the fresh window over a copy of the cache at ``org`` (covered pixels
    only). ``residual`` may be a full map (sliced), a window aligned with
    ``h_win``, or [B, C]-broadcastable."""
    _, H, W, _ = cache.shape
    WH, WW = window_extent(cov)
    fresh = h_win
    if residual is not None:
        if residual.ndim == 4 and tuple(residual.shape[1:3]) == (WH, WW) \
                and (H, W) != (WH, WW):
            r = residual  # already a window
        else:
            r = broadcast_param(residual)
            if r.shape[1] == H and r.shape[2] == W:
                r = window_slice(r, org, (WH, WW))
        fresh = fresh + r
    return paste_sessions(cache, fresh, org, cov, clamp=True)


# ---------------------------------------------------------------------
# Window-resident chains: consecutive windowed ops thread (window, cache)
# pairs and never materialize full maps between them. A carried window
# plus the producing layer's cache IS the exact full map (inside the
# window the carried values, outside the cache — they agree on the
# uncovered interior), so a later extraction window is a window-sized
# cache slice with one overlay. The planner guarantees (nested canonical
# windows across resolutions) that the carried window fits inside the
# consumer's extraction window.
# ---------------------------------------------------------------------


def window_chain_extend(
    win: torch.Tensor,
    org: torch.Tensor,
    cache: torch.Tensor,
    meta: torch.Tensor,
    edge: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
    rel: Optional[IntPair] = None,
) -> torch.Tensor:
    """Chain analogue of :func:`window_gather`: the extraction window of
    the map that is ``cache`` overlaid by the carried ``win`` at canonical
    origin ``org``, with the norm epilogue fused.

    ``rel`` is the carried window's offset inside the extraction window
    when the caller knows it (a stride-1 consumer: the conv offset); it
    is used for an in-image window. Otherwise the offset is ``org`` minus
    the window's origin. Either is clamped into the window, as
    ``sige_tpu``'s dynamic_update_slice clamps."""
    EH, EW = window_extent(edge)
    ext = crop_sessions(cache, meta, EH, EW)
    if rel is None or not is_fast_meta(meta):
        rel = org - virtual_origin(meta)
    ext = paste_sessions(ext, win, rel, clamp=True)
    return _epilogue(ext, _ring(meta, edge), scale, shift, activation,
                     activation_first)


def window_chain_extend_up2(
    win2: torch.Tensor,
    org2: torch.Tensor,
    meta: torch.Tensor,
    edge: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Chain step across a nearest-2x upsample: the planner's nesting
    makes the DOUBLED carried window (``win2`` at ``org2``, both already
    x2) cover the in-image part of the extraction window, so the step is
    one crop of the carried window — no cache read, no full map. Where
    the extraction window pokes past the image (the conv halo) it is
    zero."""
    EH, EW = window_extent(edge)
    return crop_sessions(win2, virtual_origin(meta) - org2, EH, EW,
                         _ring(meta, edge), scale, shift, activation,
                         activation_first)


def window_state_materialize(cache: torch.Tensor, win: torch.Tensor,
                             org: torch.Tensor) -> torch.Tensor:
    """Chain break: the carried window over a copy of the full cached map
    (the one full-canvas copy a chain pays, at its end)."""
    return paste_sessions(cache, win, org, clamp=True)


def window_scatter_block_residual(
    main_win: torch.Tensor,
    cache_out: torch.Tensor,
    shortcut_win: torch.Tensor,
    cache_residual: torch.Tensor,
    org: torch.Tensor,
    cov_main: torch.Tensor,
    cov_shortcut: torch.Tensor,
) -> torch.Tensor:
    """Window analogue of
    :func:`~sige_torch.ops.scatter.scatter_with_block_residual_box`; both
    paths share the canonical window, so the join is elementwise:

        out = where(m, fresh_m + y1, y0) + where(s, fresh_s - y1, 0)
    """
    shape = window_extent(cov_main)
    y0 = window_slice(cache_out, org, shape)
    y1 = window_slice(cache_residual, org, shape)
    zero = torch.zeros((), dtype=main_win.dtype, device=y0.device)
    new = (cov_where(cov_main, main_win + y1, y0)
           + cov_where(cov_shortcut, shortcut_win - y1, zero))
    return paste_sessions(cache_out, new, org, clamp=True)
