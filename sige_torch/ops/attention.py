"""Attention entry points of the engine.

Every attention in the engine is GLOBAL spatial-token attention even
under sparsity (the reference's invariant — reference:
diffusion/models/ddpm_arch/sige_fused_unet.py:179-199 scatters tiles
back before attending). Two shapes recur:

* ``mha(q, k, v)`` — all-pairs multi-head attention;
* ``masked_mha(q, ks, vs, kf, vf, bias_s, bias_f)`` — queries attend
  over [stale K/V map ++ fresh window] with additive 0/-1e9 biases
  keeping exactly one live token per spatial position (the masked
  stale-K/V chain form of the SD U-Net and VAE; the biases hold one row
  per session of the installed plan).

Both go through :func:`sige_torch.ops.flash.flash_mha`, which dispatches
on the tensor's device: on a CUDA tensor every call launches the
hand-written flash kernel (ragged lengths are masked inside it, so there
is no shape gate and no padding); on a CPU tensor it runs the plain
einsum + softmax.
"""

from __future__ import annotations

import torch

from ..utils import trace
from .flash import flash_mha
from .sessions import _clamp, _rows
from .window import window_extent

NEG_INF = -1e9


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
        dim_head: int) -> torch.Tensor:
    """Multi-head attention.

    q: [B, N, heads*dim_head]; k/v: [B, M, heads*dim_head], same dtype
    as q. Returns [B, N, heads*dim_head]."""
    with trace.span("sige.op.attention"):
        B, N, _ = q.shape
        M = k.shape[1]
        qh = q.reshape(B, N, heads, dim_head)
        kh = k.reshape(B, M, heads, dim_head)
        vh = v.reshape(B, M, heads, dim_head)
        out = flash_mha(qh, kh, vh, dim_head ** -0.5)
        return out.reshape(B, N, heads * dim_head)


def stale_fresh_biases(cov: torch.Tensor, org: torch.Tensor, res):
    """The additive biases of :func:`masked_mha` for a window at origin
    ``org`` with coverage ``cov`` on a map of ``res``: fresh window tokens
    live where covered, stale map tokens live everywhere else, so exactly
    one copy of every position is live.

    The origins are a device tensor [S, 2] (or [S, 4] window metas), one
    per session of the installed plan, and ``cov`` [S, WH, WW]:
    (bias_s [S, H*W], bias_f [S, WH*WW]), one row per session,
    built on the device from the origins without reading them on the host
    (each clamped so the window fits, as the window crop of the same call
    clamps it). float32 on ``cov``'s device."""
    H, W = res
    S = int(org.shape[0])
    WH, WW = window_extent(cov)
    dev = cov.device
    r0, c0 = _rows(org, S, dev)
    r0, c0 = _clamp(r0, WH, H), _clamp(c0, WW, W)
    # every map position's offset inside its session's window
    dr = torch.arange(H, device=dev)[None, :] - r0[:, None]  # [S, H]
    dc = torch.arange(W, device=dev)[None, :] - c0[:, None]  # [S, W]
    inside = (((dr >= 0) & (dr < WH))[:, :, None]
              & ((dc >= 0) & (dc < WW))[:, None, :])
    rows = dr.clamp(0, WH - 1)[:, :, None].expand(S, H, W)
    cols = dc.clamp(0, WW - 1)[:, None, :].expand(S, H, W)
    covered = cov[torch.arange(S, device=dev)[:, None, None], rows, cols]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    bias_s = torch.where(inside & covered, neg, zero).reshape(S, H * W)
    return bias_s, torch.where(cov.reshape(S, WH * WW), zero, neg)


def masked_mha(q: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
               kf: torch.Tensor, vf: torch.Tensor, bias_s: torch.Tensor,
               bias_f: torch.Tensor, heads: int, dim_head: int
               ) -> torch.Tensor:
    """Attention over [stale ++ fresh] K/V with per-position additive
    biases in {0, -1e9} (exactly one of the stale/fresh copies of every
    spatial position is live).

    q: [B, N, inner]; ks/vs: [B, Ms, inner] (stale maps — any cached
    dtype, cast to q's); kf/vf: [B, Mf, inner]; bias_s/bias_f: [Ms]/[Mf]
    float32, or [S, Ms]/[S, Mf] with one row per session of a batch
    stacked over S sessions (:func:`stale_fresh_biases`)."""
    with trace.span("sige.op.attention"):
        B, N, _ = q.shape
        Ms, Mf = ks.shape[1], kf.shape[1]
        qh = q.reshape(B, N, heads, dim_head)
        # the concatenation promotes a narrow stale map as it copies it
        kh = torch.cat([ks.reshape(B, Ms, heads, dim_head),
                        kf.reshape(B, Mf, heads, dim_head)],
                       dim=1).to(q.dtype)
        vh = torch.cat([vs.reshape(B, Ms, heads, dim_head),
                        vf.reshape(B, Mf, heads, dim_head)],
                       dim=1).to(q.dtype)
        bias = torch.cat([bias_s, bias_f], dim=-1).to(torch.float32)
        out = flash_mha(qh, kh, vh, dim_head ** -0.5, bias=bias)
        return out.reshape(B, N, heads * dim_head)
