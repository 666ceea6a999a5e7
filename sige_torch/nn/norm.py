"""Normalization folding.

The reference fuses normalizations into the gather/scatter epilogues by
rewriting each norm as a per-channel affine ``scale * x + shift`` computed
from the *full-mode* pass statistics (reference: diffusion/models/common.py
``my_group_norm``; gaugan/models/.../sige_normalization.py BatchNorm fold;
mobile_modules.py ``my_instance_norm``). Sparse tiles then apply the affine
without ever seeing the full map.

All functions are NHWC.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def group_norm_with_affine(
    x: torch.Tensor,
    num_groups: int,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    band=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm over NHWC returning (normalized x, scale[B, C], shift[B, C])
    such that ``scale * raw_x + shift == normalized x``
    (reference: diffusion/models/common.py:37-57).

    ``band``: this rank's row band (``SIGECtx.band``) when ``x`` is its
    band of a map sharded by rows: the statistics are the whole map's,
    two passes as on one card (the mean from the all-reduced fp32 sums,
    then the variance from the all-reduced sums of squared deviations),
    the same bits on every rank."""
    B, H, W, C = x.shape
    gs = C // num_groups
    in_dtype = x.dtype
    # statistics always in fp32
    xg = x.to(torch.float32).reshape(B, H, W, num_groups, gs)
    if band is None:
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)             # [B,1,1,G,1]
        var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    else:
        n = band.height(H) * W * gs
        mean = band.all_reduce(xg.sum(dim=(1, 2, 4), keepdim=True)) / n
        var = band.all_reduce(
            (xg - mean).square().sum(dim=(1, 2, 4), keepdim=True)) / n
    std = torch.sqrt(var + eps)
    xn = ((xg - mean) / std).reshape(B, H, W, C).to(in_dtype)
    scale = (1.0 / std)[:, 0, 0, :, 0]                          # [B, G]
    shift = (-mean / std)[:, 0, 0, :, 0]
    scale = scale.repeat_interleave(gs, dim=-1)                 # [B, C]
    shift = shift.repeat_interleave(gs, dim=-1)
    if weight is not None:
        xn = xn * weight
        scale = scale * weight
        shift = shift * weight
    if bias is not None:
        xn = xn + bias
        shift = shift + bias
    return xn, scale, shift


def instance_norm_stats(
    x: torch.Tensor, eps: float = 1e-5, band=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """InstanceNorm statistics of NHWC ``x``, per (batch, channel), in
    fp32: (mean, rstd), each [B, 1, 1, C], with ``(x - mean) * rstd`` the
    normalized map (reference: gaugan/models/sub_mobile_spade_generators/
    mobile_modules.py ``my_instance_norm``).

    A fold caches these rather than ``sige_tpu``'s (scale, shift) =
    (rstd, -mean * rstd): the same function, but a channel of (near) zero
    variance has rstd up to 1/sqrt(eps), and ``x * scale + shift`` turns
    the rounding of its two large terms into noise of that size, which
    differs between the full and the sparse pass; ``x - mean`` is exact
    there. ``band``: as for :func:`group_norm_with_affine`, the whole
    map's statistics from a row band's, the same bits on every rank."""
    xf = x.to(torch.float32)
    if band is None:
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    else:
        n = band.height(xf.shape[1]) * xf.shape[2]
        mean = band.all_reduce(xf.sum(dim=(1, 2), keepdim=True)) / n
        var = band.all_reduce(
            (xf - mean).square().sum(dim=(1, 2), keepdim=True)) / n
    return mean, torch.rsqrt(var + eps)


def batch_norm_affine(
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm is data-independent: return (scale[C], shift[C])
    from running stats (reference: gaugan/models/spade_generators/
    sige_normalization.py:61-88)."""
    inv = 1.0 / torch.sqrt(running_var + eps)
    scale = inv if weight is None else inv * weight
    shift = -running_mean * scale
    if bias is not None:
        shift = shift + bias
    return scale, shift
