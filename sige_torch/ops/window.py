"""Window-layout ops: one contiguous crop window per layer instead of tiles.

The port of ``sige_tpu.ops.window``. For a compact edit the active tiles
form a (nearly) dense sub-grid, so each layer can instead extract ONE
axis-aligned window of its input (the bucketed canonical window plus the
conv's halo), run the dense conv on it, and overlay the result on the
cache. Coverage masks planned on the host keep the tile engine's
fresh-vs-cached semantics exactly on the original input.

Plan products arrive in two forms. Window metas and origins are host
integers read from the host plan (as the tile joins read their bbox
origins), so an in-image window is a slice of the map — a view, with no
device-to-host copy. Coverage and edge masks are bool tensors on the
device.

Border windows: ``sige_tpu`` slices at a clamped start, rolls the window
back into alignment and zeroes the out-of-image ring with the planned
edge mask. Here the in-image part is sliced and zero-padded to the
window's extent, which gives the same values, also for an extent wider
than the canvas. A meta is the planner's 2-form ``(r, c)`` (the window is
fully in image) or 4-form ``(clamped_r, clamped_c, roll_r, roll_c)``; the
window's virtual origin is ``clamped - roll``.

Per-session form: under a stacked plan (S sessions of B samples run as
one batch of S*B, ``sige_torch.parallel.SessionServer``) metas and
origins arrive as int64 device tensors ``[S, k]`` and masks as
``[S, h, w]``; a tensor origin selects that form, whose body builds on
:func:`~sige_torch.ops.sessions.crop_sessions` and
:func:`~sige_torch.ops.sessions.paste_sessions` (a hand-written kernel
each on the card). A host tuple keeps the single-plan form.

No op writes into its inputs: caches hold the full pass's activations
themselves, so every overlay writes into a copy. A cache may be stored
in a narrower dtype than the fresh values (``SIGEModel(cache_dtype=)``):
the overlay's copy is made in the fresh values' dtype (the cast rides in
the copy), and the elementwise joins promote, so fresh windows are never
rounded to the cache's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .gather import apply_epilogue, broadcast_param
from .scatter import clamp_origin
from .sessions import (cov_where, crop_sessions, is_sessions,
                       paste_sessions, virtual_origin)

IntPair = Tuple[int, int]


def is_fast_meta(meta) -> bool:
    """The 2-form meta: a window fully inside the image (host ints, or a
    [S, 2] tensor of per-session metas)."""
    return (meta.shape[-1] if is_sessions(meta) else len(meta)) == 2


def window_extent(mask: torch.Tensor) -> IntPair:
    """(h, w) of a coverage or edge mask, [h, w] or [S, h, w]."""
    return tuple(mask.shape[-2:])


def scale_origin(org, k: int):
    """``k * org`` for a host origin or a [S, 2] tensor of them."""
    if is_sessions(org):
        return k * org
    return tuple(k * int(o) for o in org)


def sub_origin(a, b):
    """``a - b`` for host origins or [S, 2] tensors of them."""
    if is_sessions(a) or is_sessions(b):
        return a - b
    return tuple(int(x) - int(y) for x, y in zip(a, b))


def _origin(meta: Sequence[int]) -> IntPair:
    """The window's virtual (possibly negative) origin."""
    if is_fast_meta(meta):
        return int(meta[0]), int(meta[1])
    return int(meta[0]) - int(meta[2]), int(meta[1]) - int(meta[3])


def _crop(x: torch.Tensor, r: int, c: int, eh: int, ew: int) -> torch.Tensor:
    """[B, eh, ew, C] window of ``x`` at (r, c): the part inside ``x``
    sliced (a view when that is all of it), the rest zero."""
    _, H, W, _ = x.shape
    r0, r1 = max(r, 0), min(r + eh, H)
    c0, c1 = max(c, 0), min(c + ew, W)
    w = x[:, r0:r1, c0:c1]
    pads = (0, 0, c0 - c, c + ew - c1, r0 - r, r + eh - r1)
    return F.pad(w, pads) if any(pads) else w


def _extract_window(x: torch.Tensor, meta: Sequence[int],
                    edge: torch.Tensor) -> torch.Tensor:
    """[B, EH, EW, C] window of ``x`` at the planned origin; ``edge``
    (bool [EH, EW]) gives the extent."""
    EH, EW = edge.shape
    return _crop(x, *_origin(meta), EH, EW)


def _paste(base: torch.Tensor, win: torch.Tensor, r: int, c: int,
           cov: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A copy of ``base`` in ``win``'s dtype with ``win`` written at
    (r, c) — where ``cov`` is set, when given."""
    out = base.to(win.dtype, copy=True)
    h, w = win.shape[1:3]
    dst = out[:, r:r + h, c:c + w]
    dst.copy_(win if cov is None
              else torch.where(cov[None, :, :, None], win, dst))
    return out


def _epilogue(z, edge, scale, shift, activation, activation_first):
    """Fused scale/shift/activation; ``edge=None`` skips re-zeroing the
    out-of-image ring (fast windows are fully in image)."""
    z = apply_epilogue(z, broadcast_param(scale), broadcast_param(shift),
                       activation, activation_first)
    if edge is None:
        return z
    return torch.where(edge[None, :, :, None], z,
                       torch.zeros((), dtype=z.dtype, device=z.device))


def _epilogue_sessions(z, edge, scale, shift, activation,
                       activation_first):
    """Per-session :func:`_epilogue`: the epilogue and the [S, EH, EW]
    edge in one pass over the window (a crop at its own origin)."""
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
    and the activation, then the out-of-image ring re-zeroed (``edge``;
    None for an in-image window; [S, EH, EW] per session)."""
    if edge is not None and edge.ndim == 3:
        return _epilogue_sessions(z, edge, scale, shift, activation,
                                  activation_first)
    return _epilogue(z, edge, scale, shift, activation, activation_first)


def window_gather(
    x: torch.Tensor,
    meta: Sequence[int],
    edge: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Window analogue of :func:`~sige_torch.ops.gather.gather_tiles`:
    the conv input window (with halo) of ``x``, the folded-norm epilogue
    fused, the out-of-image ring zero."""
    if is_sessions(meta):
        EH, EW = window_extent(edge)
        return crop_sessions(x, meta, EH, EW,
                             None if is_fast_meta(meta) else edge, scale,
                             shift, activation, activation_first)
    w = _extract_window(x, meta, edge)
    return _epilogue(w, None if is_fast_meta(meta) else edge, scale, shift,
                     activation, activation_first)


def window_scatter_gather(
    h_win: torch.Tensor,
    cache: torch.Tensor,
    meta: Sequence[int],
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
    if is_sessions(meta):
        EH, EW = window_extent(edge)
        z = paste_sessions(crop_sessions(cache, meta, EH, EW), h_win, pad,
                           cov)
        return _epilogue_sessions(z, None if is_fast_meta(meta) else edge,
                                  scale, shift, activation, activation_first)
    base = _extract_window(cache, meta, edge)
    z = _paste(base, h_win, pad[0], pad[1], cov)
    return _epilogue(z, None if is_fast_meta(meta) else edge, scale, shift,
                     activation, activation_first)


def window_slice(x: torch.Tensor, org: Sequence[int],
                 shape: Sequence[int]) -> torch.Tensor:
    """[B, WH, WW, C] in-image window of ``x`` at host origin ``org`` (a
    view; canonical windows are always in image). Per session: a copy."""
    if is_sessions(org):
        return crop_sessions(x, org, shape[0], shape[1], clamp=True)
    _, H, W, _ = x.shape
    r0, c0 = clamp_origin(org, tuple(shape), (H, W))
    return x[:, r0:r0 + shape[0], c0:c0 + shape[1]]


def window_scatter(
    h_win: torch.Tensor,
    cache: torch.Tensor,
    org: Sequence[int],
    cov: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Window analogue of :func:`~sige_torch.ops.scatter.scatter_tiles_box`:
    the fresh window over a copy of the cache at ``org`` (covered pixels
    only). ``residual`` may be a full map (sliced), a window aligned with
    ``h_win``, or [B, C]-broadcastable."""
    if is_sessions(org):
        return _window_scatter_sessions(h_win, cache, org, cov, residual)
    _, H, W, _ = cache.shape
    WH, WW = cov.shape
    r0, c0 = clamp_origin(org, (WH, WW), (H, W))
    fresh = h_win
    if residual is not None:
        if residual.ndim == 4 and tuple(residual.shape[1:3]) == (WH, WW) \
                and (H, W) != (WH, WW):
            r = residual  # already a window
        else:
            r = broadcast_param(residual)
            if r.shape[1] == H and r.shape[2] == W:
                r = r[:, r0:r0 + WH, c0:c0 + WW]
        fresh = fresh + r
    return _paste(cache, fresh, r0, c0, cov)


def _window_scatter_sessions(h_win, cache, org, cov, residual):
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
                r = crop_sessions(r, org, WH, WW, clamp=True)
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
    org: Sequence[int],
    cache: torch.Tensor,
    meta: Sequence[int],
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
    if is_sessions(meta):
        EH, EW = window_extent(edge)
        ext = crop_sessions(cache, meta, EH, EW)
        if rel is None or not is_fast_meta(meta):
            rel = org - virtual_origin(meta)
        ext = paste_sessions(ext, win, rel, clamp=True)
        return _epilogue_sessions(ext, None if is_fast_meta(meta) else edge,
                                  scale, shift, activation, activation_first)
    ext = _extract_window(cache, meta, edge)
    if rel is None or not is_fast_meta(meta):
        v = _origin(meta)
        rel = (int(org[0]) - v[0], int(org[1]) - v[1])
    pr, pc = clamp_origin(rel, tuple(win.shape[1:3]), tuple(ext.shape[1:3]))
    ext = _paste(ext, win, pr, pc)
    return _epilogue(ext, None if is_fast_meta(meta) else edge, scale, shift,
                     activation, activation_first)


def window_chain_extend_up2(
    win2: torch.Tensor,
    org2: Sequence[int],
    meta: Sequence[int],
    edge: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Chain step across a nearest-2x upsample: the planner's nesting
    makes the DOUBLED carried window (``win2`` at ``org2``, both already
    x2) cover the in-image part of the extraction window, so the step is
    one slice of the carried window — no cache read, no full map. Where
    the extraction window pokes past the image (the conv halo) it is
    zero."""
    if is_sessions(meta):
        EH, EW = window_extent(edge)
        return crop_sessions(win2, virtual_origin(meta) - org2, EH, EW,
                             None if is_fast_meta(meta) else edge, scale,
                             shift, activation, activation_first)
    EH, EW = edge.shape
    v_r, v_c = _origin(meta)
    ext = _crop(win2, v_r - int(org2[0]), v_c - int(org2[1]), EH, EW)
    return _epilogue(ext, None if is_fast_meta(meta) else edge, scale, shift,
                     activation, activation_first)


def window_state_materialize(cache: torch.Tensor, win: torch.Tensor,
                             org: Sequence[int]) -> torch.Tensor:
    """Chain break: the carried window over a copy of the full cached map
    (the one full-canvas copy a chain pays, at its end)."""
    if is_sessions(org):
        return paste_sessions(cache, win, org, clamp=True)
    _, H, W, _ = cache.shape
    r0, c0 = clamp_origin(org, tuple(win.shape[1:3]), (H, W))
    return _paste(cache, win, r0, c0)


def window_scatter_block_residual(
    main_win: torch.Tensor,
    cache_out: torch.Tensor,
    shortcut_win: torch.Tensor,
    cache_residual: torch.Tensor,
    org: Sequence[int],
    cov_main: torch.Tensor,
    cov_shortcut: torch.Tensor,
) -> torch.Tensor:
    """Window analogue of
    :func:`~sige_torch.ops.scatter.scatter_with_block_residual_box`; both
    paths share the canonical window, so the join is elementwise:

        out = where(m, fresh_m + y1, y0) + where(s, fresh_s - y1, 0)
    """
    if is_sessions(org):
        WH, WW = window_extent(cov_main)
        y0 = crop_sessions(cache_out, org, WH, WW, clamp=True)
        y1 = crop_sessions(cache_residual, org, WH, WW, clamp=True)
        zero = torch.zeros((), dtype=main_win.dtype, device=y0.device)
        new = (cov_where(cov_main, main_win + y1, y0)
               + cov_where(cov_shortcut, shortcut_win - y1, zero))
        return paste_sessions(cache_out, new, org, clamp=True)
    out = cache_out.to(main_win.dtype, copy=True)
    sl0 = window_slice(out, org, cov_main.shape)  # the copy's: no cast
    sl1 = window_slice(cache_residual, org, cov_main.shape)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    sl0.copy_(torch.where(cov_main[None, :, :, None], main_win + sl1, sl0)
              + torch.where(cov_shortcut[None, :, :, None],
                            shortcut_win - sl1, zero))
    return out
