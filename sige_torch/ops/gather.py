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

Implementation: one ``torch.gather`` at clamped coordinates, the
epilogue, and a validity select. The indices lead with the installed
plan's S >= 1 sessions (S sessions of B samples run as one batch of S*B;
one session's plan is a stack of one): ``[S, K, 2]`` and counts ``[S]``,
and each session's samples gather at its own positions.
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
      x: [B, H, W, C] feature map (B = S * samples per session).
      indices: [S, K, 2] integer padded tile top-lefts (input
        coordinates), per session.
      count: [S] numbers of live tiles.
      geom: block geometry.
      scale / shift: folded-norm epilogue params, [C], [B, C] or NHWC
        broadcastable. Spatially-varying params are gathered alongside x.
      activation / activation_first: epilogue activation and its order.

    Returns:
      [B * K, bh, bw, C] tile batch; dead pixels/tiles are exactly zero.
    """
    N, H, W, C = x.shape
    S, K = indices.shape[:2]
    bh, bw = geom.block_size
    idx = indices.to(torch.int64)
    dev = idx.device
    rows = (idx[:, :, 0:1] + torch.arange(bh, device=dev))[:, :, :, None]
    cols = (idx[:, :, 1:2] + torch.arange(bw, device=dev))[:, :, None, :]
    live = torch.arange(K, device=dev)[None, :] < torch.as_tensor(
        count, device=dev).reshape(S, 1)
    valid = ((rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
             & live[:, :, None, None])                     # [S, K, bh, bw]
    flat = (rows.clamp(0, H - 1) * W + cols.clamp(0, W - 1)).reshape(S, -1)

    def take(p):
        return take_sessions(p.reshape(p.shape[0], -1, p.shape[3]), flat
                             ).reshape(p.shape[0], K, bh, bw, p.shape[3])

    def gather_param(p):
        p = broadcast_param(p)
        if p is None:
            return None
        if p.shape[1] == 1 and p.shape[2] == 1:
            return p[:, None]  # [B', 1, 1, 1, C'] broadcasts over tiles
        return take(p)

    tiles = apply_epilogue(take(x), gather_param(scale), gather_param(shift),
                           activation, activation_first)
    tiles = torch.where(valid[:, None, :, :, :, None],
                        tiles.unflatten(0, (S, -1)),
                        torch.zeros((), dtype=tiles.dtype, device=x.device))
    return tiles.reshape(N * K, bh, bw, C)


def take_sessions(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[n, index[s]]`` over the middle axis of [S*B, P, C] for every
    sample n = s*B + b: [S*B, M, C] (index [S, M], clamped at 0)."""
    S, M = index.shape
    N, _, C = t.shape
    src = index.clamp_min(0)[:, None, :, None].expand(S, N // S, M, C)
    return torch.gather(t.unflatten(0, (S, -1)), 2, src).flatten(0, 1)
