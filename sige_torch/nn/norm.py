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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm over NHWC returning (normalized x, scale[B, C], shift[B, C])
    such that ``scale * raw_x + shift == normalized x``
    (reference: diffusion/models/common.py:37-57)."""
    B, H, W, C = x.shape
    gs = C // num_groups
    in_dtype = x.dtype
    # statistics always in fp32
    xg = x.to(torch.float32).reshape(B, H, W, num_groups, gs)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)                 # [B,1,1,G,1]
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
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


def instance_norm_with_affine(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm fold — per (batch, channel) statistics
    (reference: gaugan/models/sub_mobile_spade_generators/mobile_modules.py
    ``my_instance_norm``)."""
    return group_norm_with_affine(x, x.shape[-1], weight, bias, eps)


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
