"""Attention entry points of the engine.

Every attention in the engine is GLOBAL spatial-token attention even
under sparsity (the reference's invariant — reference:
diffusion/models/ddpm_arch/sige_fused_unet.py:179-199 scatters tiles
back before attending). Two shapes recur:

* ``mha(q, k, v)`` — all-pairs multi-head attention;
* ``masked_mha(q, ks, vs, kf, vf, bias_s, bias_f)`` — queries attend
  over [stale K/V map ++ fresh window] with additive 0/-1e9 biases
  keeping exactly one live token per spatial position (the masked
  stale-K/V chain form of the SD U-Net).

Both go through :func:`sige_torch.ops.flash.flash_mha`, which dispatches
on the tensor's device: on a CUDA tensor every call launches the
hand-written flash kernel (ragged lengths are masked inside it, so there
is no shape gate and no padding); on a CPU tensor it runs the plain
einsum + softmax.
"""

from __future__ import annotations

import torch

from .flash import flash_mha

NEG_INF = -1e9


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
        dim_head: int) -> torch.Tensor:
    """Multi-head attention.

    q: [B, N, heads*dim_head]; k/v: [B, M, heads*dim_head], same dtype
    as q. Returns [B, N, heads*dim_head]."""
    B, N, _ = q.shape
    M = k.shape[1]
    qh = q.reshape(B, N, heads, dim_head)
    kh = k.reshape(B, M, heads, dim_head)
    vh = v.reshape(B, M, heads, dim_head)
    out = flash_mha(qh, kh, vh, dim_head ** -0.5)
    return out.reshape(B, N, heads * dim_head)


def stale_fresh_biases(cov: torch.Tensor, org, res):
    """The additive biases of :func:`masked_mha` for a window at host
    origin ``org`` with coverage ``cov`` (bool [WH, WW]) on a map of
    ``res``: fresh window tokens live where covered, stale map tokens live
    everywhere else, so exactly one copy of every position is live.
    Returns (bias_s [H*W], bias_f [WH*WW]), float32 on ``cov``'s device."""
    WH, WW = cov.shape
    zero = torch.zeros((), dtype=torch.float32, device=cov.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=cov.device)
    bias_s = torch.zeros(tuple(res), dtype=torch.float32, device=cov.device)
    bias_s[org[0]:org[0] + WH, org[1]:org[1] + WW] = torch.where(
        cov, neg, zero)
    return bias_s.reshape(-1), torch.where(cov.reshape(-1), zero, neg)


def masked_mha(q: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
               kf: torch.Tensor, vf: torch.Tensor, bias_s: torch.Tensor,
               bias_f: torch.Tensor, heads: int, dim_head: int
               ) -> torch.Tensor:
    """Attention over [stale ++ fresh] K/V with per-position additive
    biases in {0, -1e9} (exactly one of the stale/fresh copies of every
    spatial position is live).

    q: [B, N, inner]; ks/vs: [B, Ms, inner] (stale maps — any cached
    dtype, cast to q's); kf/vf: [B, Mf, inner]; bias_s/bias_f: [Ms]/[Mf]
    float32."""
    B, N, _ = q.shape
    Ms, Mf = ks.shape[1], kf.shape[1]
    qh = q.reshape(B, N, heads, dim_head)
    # the concatenation promotes a narrow stale map as it copies it
    kh = torch.cat([ks.reshape(B, Ms, heads, dim_head),
                    kf.reshape(B, Mf, heads, dim_head)], dim=1).to(q.dtype)
    vh = torch.cat([vs.reshape(B, Ms, heads, dim_head),
                    vf.reshape(B, Mf, heads, dim_head)], dim=1).to(q.dtype)
    bias = torch.cat([bias_s, bias_f]).to(torch.float32)
    out = flash_mha(qh, kh, vh, dim_head ** -0.5, bias=bias)
    return out.reshape(B, N, heads * dim_head)
