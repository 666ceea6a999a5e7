"""Tile gather with fused normalization epilogue.

``gather_tiles`` extracts the active activation tiles covering the edited
region into a dense tile batch ``[B * K, bh, bw, C]`` with an optional
fused ``scale * x + shift`` + activation epilogue (the folded
GroupNorm/BatchNorm the reference fuses into its gather kernels;
reference: sige/cpu/gather.cpp:4-114).

Semantics (matching the reference kernel and ``sige_tpu.ops.gather``):
  * tile top-lefts live in padded input coordinates and may be negative;
  * out-of-bounds pixels are exactly zero — the epilogue is *not* applied
    to them (the reference writes 0 and continues);
  * padded index-buffer slots (>= ``count``) produce all-zero tiles.

Implementation: one flat ``index_select`` at clamped coordinates, the
epilogue, and a validity select. Under a stacked plan (S sessions of B
samples as one batch, ``sige_torch.parallel.SessionServer``) the indices
are ``[S, K, 2]`` and the counts ``[S]``, and each session's samples
gather at its own positions (one ``torch.gather``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.geometry import BlockGeometry

_ACTIVATIONS = {
    "identity": lambda x: x,
    "swish": lambda x: x * torch.sigmoid(x),
    "relu": torch.relu,
    "leaky": lambda x: F.leaky_relu(x, 0.2),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def apply_epilogue(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor],
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Fused ``scale * x + shift`` and activation, in either order
    (reference: sige/cpu/gather.cpp:37-53)."""
    act = _ACTIVATIONS[activation]
    if activation_first:
        x = act(x)
        if scale is not None:
            x = x * scale
        if shift is not None:
            x = x + shift
    else:
        if scale is not None:
            x = x * scale
        if shift is not None:
            x = x + shift
        x = act(x)
    return x


def broadcast_param(p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Normalize an epilogue param to rank-4 NHWC broadcastable form."""
    if p is None:
        return None
    if p.ndim == 1:  # [C]
        return p.reshape(1, 1, 1, -1)
    if p.ndim == 2:  # [B, C]
        return p.reshape(p.shape[0], 1, 1, p.shape[1])
    if p.ndim == 4:
        return p
    raise ValueError(f"epilogue param rank {p.ndim} unsupported")


def tile_pixel_index(indices: torch.Tensor, count, geom: BlockGeometry,
                     H: int, W: int):
    """Flat clamped pixel index [K*bh*bw] and validity mask [K, bh, bw] of
    every tile pixel (in bounds and in a live slot)."""
    K = indices.shape[0]
    bh, bw = geom.block_size
    idx = indices.to(torch.int64)
    ar_h = torch.arange(bh, device=idx.device)
    ar_w = torch.arange(bw, device=idx.device)
    rows = (idx[:, 0:1] + ar_h[None, :])[:, :, None]   # [K, bh, 1]
    cols = (idx[:, 1:2] + ar_w[None, :])[:, None, :]   # [K, 1, bw]
    live = torch.arange(K, device=idx.device) < torch.as_tensor(
        count, device=idx.device)
    valid = ((rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
             & live[:, None, None])
    flat = (rows.clamp(0, H - 1) * W + cols.clamp(0, W - 1)).reshape(-1)
    return flat, valid


def gather_tiles(
    x: torch.Tensor,
    indices: torch.Tensor,
    count,
    geom: BlockGeometry,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    activation: str = "identity",
    activation_first: bool = False,
) -> torch.Tensor:
    """Gather active tiles from a feature map.

    Args:
      x: [B, H, W, C] feature map.
      indices: [K, 2] integer padded tile top-lefts (input coordinates),
        or [S, K, 2] per session (B = S * samples per session).
      count: number of live tiles (int or scalar tensor; [S] per
        session).
      geom: block geometry.
      scale / shift: folded-norm epilogue params, [C], [B, C] or NHWC
        broadcastable. Spatially-varying params are gathered alongside x.
      activation / activation_first: epilogue activation and its order.

    Returns:
      [B * K, bh, bw, C] tile batch; dead pixels/tiles are exactly zero.
    """
    if indices.ndim == 3:
        return _gather_tiles_sessions(x, indices, count, geom, scale, shift,
                                      activation, activation_first)
    B, H, W, C = x.shape
    K = indices.shape[0]
    bh, bw = geom.block_size
    flat, valid = tile_pixel_index(indices, count, geom, H, W)
    tiles = x.reshape(B, H * W, C).index_select(1, flat)
    tiles = tiles.reshape(B, K, bh, bw, C)

    def gather_param(p):
        p = broadcast_param(p)
        if p is None:
            return None
        if p.shape[1] == 1 and p.shape[2] == 1:
            return p[:, None]  # [B', 1, 1, 1, C'] broadcasts over tiles
        return p.reshape(p.shape[0], -1, p.shape[3]).index_select(
            1, flat).reshape(p.shape[0], K, bh, bw, p.shape[3])

    tiles = apply_epilogue(tiles, gather_param(scale), gather_param(shift),
                           activation, activation_first)
    tiles = torch.where(valid[None, :, :, :, None], tiles,
                        torch.zeros((), dtype=tiles.dtype, device=tiles.device))
    return tiles.reshape(B * K, bh, bw, C)


def session_pixel_index(indices: torch.Tensor, count, geom: BlockGeometry,
                        H: int, W: int):
    """Per-session :func:`tile_pixel_index`: indices [S, K, 2] and counts
    [S] -> flat [S, K*bh*bw] and valid [S, K, bh, bw]."""
    S, K = indices.shape[:2]
    bh, bw = geom.block_size
    idx = indices.to(torch.int64)
    dev = idx.device
    rows = (idx[:, :, 0:1] + torch.arange(bh, device=dev))[:, :, :, None]
    cols = (idx[:, :, 1:2] + torch.arange(bw, device=dev))[:, :, None, :]
    live = torch.arange(K, device=dev)[None, :] < torch.as_tensor(
        count, device=dev).reshape(S, 1)
    valid = ((rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
             & live[:, :, None, None])
    flat = (rows.clamp(0, H - 1) * W + cols.clamp(0, W - 1)).reshape(S, -1)
    return flat, valid


def take_sessions(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[n, index[s]]`` over the middle axis of [S*B, P, C] for every
    sample n = s*B + b: [S*B, M, C] (index [S, M], clamped at 0)."""
    S, M = index.shape
    N, _, C = t.shape
    src = index.clamp_min(0)[:, None, :, None].expand(S, N // S, M, C)
    return torch.gather(t.unflatten(0, (S, -1)), 2, src).flatten(0, 1)


def _gather_tiles_sessions(x, indices, count, geom, scale, shift,
                           activation, activation_first):
    N, H, W, C = x.shape
    S, K = indices.shape[:2]
    bh, bw = geom.block_size
    flat, valid = session_pixel_index(indices, count, geom, H, W)

    def take(p):
        return take_sessions(p.reshape(p.shape[0], -1, p.shape[3]), flat
                             ).reshape(p.shape[0], K, bh, bw, p.shape[3])

    def gather_param(p):
        p = broadcast_param(p)
        if p is None:
            return None
        if p.shape[1] == 1 and p.shape[2] == 1:
            return p[:, None]
        return take(p)

    tiles = apply_epilogue(take(x), gather_param(scale), gather_param(shift),
                           activation, activation_first)
    tiles = torch.where(valid[:, None, :, :, :, None],
                        tiles.unflatten(0, (S, -1)),
                        torch.zeros((), dtype=tiles.dtype, device=x.device))
    return tiles.reshape(N * K, bh, bw, C)
