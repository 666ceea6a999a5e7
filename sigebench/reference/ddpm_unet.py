"""Plain reference of the DDPM U-Net (Ho et al. 2020; the SIGE-wired
church256 U-Net of lmxyy/sige ``diffusion/models/ddpm_arch/
sige_fused_unet.py``) and of its sparse step, in dense form.

The model: a 3x3 stem; per level ``num_res_blocks`` resblocks (GroupNorm,
swish, 3x3 conv, the time embedding added, GroupNorm, swish, 3x3 conv,
a 1x1 shortcut where the channels change) with single-head attention at
``attn_resolutions``, a stride-2 3x3 downsample padded (0, 1, 0, 1); a
middle of resblock, attention, resblock; the up path with skip
concatenations, nearest-2x upsamples and 3x3 convs; GroupNorm, swish and
a 3x3 conv out. The time embedding is one fused projection sliced per
resblock in traversal order.

The SIGE wiring (what the sparse step recomputes): at levels of at least
``sparse_resolution_threshold`` px, every 3x3 conv of a resblock and the
downsample have a block-6 gather, the shortcut and the attention's 1x1
convs block-4 gathers; every upsample conv, the stem and the tail conv
have block-6 gathers; coarser levels and the middle run dense over the
original's norm statistics.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .common import (Pass, attention, conv, linear, sparse_region, swish,
                     timestep_sincos, to_nchw, to_nhwc, tokens, untokens,
                     up2)



def _cfg(cfg: Mapping) -> Dict:
    base = dict(block_size_normal=6, block_size_instance=4,
                ch=128, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
                attn_resolutions=(16,), in_ch=3, out_ch=3, resolution=256,
                num_groups=32, sparse_resolution_threshold=64)
    base.update(cfg)
    return base


def param_shapes(cfg: Mapping) -> Dict[str, tuple]:
    """Every parameter's name and shape, as the port's state dict names
    them."""
    c = _cfg(cfg)
    ch, mult, nrb = c["ch"], tuple(c["ch_mult"]), c["num_res_blocks"]
    temb = 4 * ch
    S: Dict[str, tuple] = {}

    def lin(name, i, o):
        S[name + ".weight"], S[name + ".bias"] = (o, i), (o,)

    def cv(name, i, o, k):
        S[name + ".weight"], S[name + ".bias"] = (o, i, k, k), (o,)

    def norm(name, n):
        S[name + ".weight"], S[name + ".bias"] = (n,), (n,)

    def res(name, i, o):
        norm(name + ".norm1", i)
        cv(name + ".conv1", i, o, 3)
        norm(name + ".norm2", o)
        cv(name + ".conv2", o, o, 3)
        if i != o:
            cv(name + ".nin_shortcut", i, o, 1)
        return o

    def attn(name, n):
        norm(name + ".norm", n)
        cv(name + ".qkv", n, 3 * n, 1)
        cv(name + ".proj_out", n, n, 1)

    lin("temb_dense0", ch, temb)
    lin("temb_dense1", temb, temb)
    cv("conv_in", c["in_ch"], ch, 3)
    in_mult = (1,) + mult
    res_sizes = []
    cur = c["resolution"]
    for i in range(len(mult)):
        bi = ch * in_mult[i]
        for ib in range(nrb):
            bi = res(f"down_blocks.{i}.{ib}", bi, ch * mult[i])
            res_sizes.append(bi)
            if cur in c["attn_resolutions"]:
                attn(f"down_attns.{i}.{ib}", bi)
        if i != len(mult) - 1:
            cv(f"downsamples.{i}.conv", bi, bi, 3)
            cur //= 2
    for name in ("mid_block1", "mid_block2"):
        res(name, bi, bi)
        res_sizes.append(bi)
    attn("mid_attn", bi)
    for i in reversed(range(len(mult))):
        skip = ch * mult[i]
        for ib in range(nrb + 1):
            if ib == nrb:
                skip = ch * in_mult[i]
            bi = res(f"up_blocks.{i}.{ib}", bi + skip, ch * mult[i])
            res_sizes.append(bi)
            if cur in c["attn_resolutions"]:
                attn(f"up_attns.{i}.{ib}", bi)
        if i != 0:
            cv(f"upsamples.{i - 1}.conv", bi, bi, 3)
            cur *= 2
    lin("temb_proj", temb, sum(res_sizes))
    norm("norm_out", bi)
    S["norm_out_scale"], S["norm_out_bias"] = S.pop("norm_out.weight"), \
        S.pop("norm_out.bias")
    cv("conv_out", bi, c["out_ch"], 3)
    return S


def forward(P: Mapping, cfg: Mapping, x: torch.Tensor, t: torch.Tensor,
            run: Pass) -> torch.Tensor:
    """x [B, R, R, in_ch] NHWC, t [B] -> [B, R, R, out_ch]."""
    c = _cfg(cfg)
    G_MAIN = (c["block_size_normal"], 3, 1, 1)  # block, kernel, stride, offset
    G_DOWN = (c["block_size_normal"], 3, 2, 0)
    G_ONE = (c["block_size_instance"], 1, 1, 0)
    ch, mult, nrb = c["ch"], tuple(c["ch_mult"]), c["num_res_blocks"]
    G, thr = c["num_groups"], c["sparse_resolution_threshold"]
    nres = len(mult)

    temb = timestep_sincos(t, ch, cos_first=False, denom_offset=1)
    temb = swish(linear(P, "temb_dense0", temb))
    temb = swish(linear(P, "temb_dense1", temb))
    temb = linear(P, "temb_proj", temb)
    at = [0]

    def tslice(n):
        s = temb[:, at[0]:at[0] + n]
        at[0] += n
        return s

    def res(name, h, sparse, hw):
        with sparse_region(hw if sparse else None):
            return _res(name, h, sparse, hw)

    def _res(name, h, sparse, hw):
        cin = h.shape[1]
        cout = P[name + ".conv1.weight"].shape[0]
        t_add = tslice(cout)
        a = swish(run.group_norm(name + ".norm1", h, P[name + ".norm1.weight"],
                                 P[name + ".norm1.bias"], G))
        a = conv(P, name + ".conv1", a)
        if sparse:
            a = run.scatter(name + ".sg", a, hw, G_MAIN)
        a = a + t_add[:, :, None, None]
        a = swish(run.group_norm(name + ".norm2", a, P[name + ".norm2.weight"],
                                 P[name + ".norm2.bias"], G))
        a = conv(P, name + ".conv2", a)
        xs = conv(P, name + ".nin_shortcut", h, padding=0) if cin != cout \
            else h
        if not sparse:
            return a + xs
        if cin != cout:
            return run.block_residual(name + ".join", a, xs, hw, G_MAIN,
                                      G_ONE)
        return run.scatter(name + ".join", a + xs, hw, G_MAIN)

    def attn(name, h, sparse, hw):
        with sparse_region(hw if sparse else None):
            return _attn(name, h, sparse, hw)

    def _attn(name, h, sparse, hw):
        n = h.shape[1]
        a = run.group_norm(name + ".norm", h, P[name + ".norm.weight"],
                           P[name + ".norm.bias"], G)
        qkv = conv(P, name + ".qkv", a, padding=0)
        if sparse:
            qkv = run.scatter(name + ".scatter1", qkv, hw, G_ONE)
        q, k, v = tokens(qkv).split(n, dim=-1)
        a = untokens(attention(q, k, v, 1), hw)
        a = conv(P, name + ".proj_out", a, padding=0)
        if sparse:
            return run.scatter(name + ".scatter2", a + h, hw, G_ONE)
        return a + h

    x = to_nchw(x)
    cur = c["resolution"]
    hw = (cur, cur)
    with sparse_region(hw if cur >= thr else None):
        h = conv(P, "conv_in", x)
    if cur >= thr:
        h = run.scatter("conv_in", h, hw, G_MAIN)
    hs = [h]
    for i in range(nres):
        sparse = cur >= thr
        for ib in range(nrb):
            h = res(f"down_blocks.{i}.{ib}", hs[-1], sparse, (cur, cur))
            if cur in c["attn_resolutions"]:
                h = attn(f"down_attns.{i}.{ib}", h, sparse, (cur, cur))
            hs.append(h)
        if i != nres - 1:
            with sparse_region((cur // 2, cur // 2) if sparse else None):
                h = conv(P, f"downsamples.{i}.conv", hs[-1], stride=2,
                         padding=(0, 1, 0, 1))
            if sparse:
                h = run.scatter(f"downsamples.{i}", h, (cur, cur), G_DOWN)
            hs.append(h)
            cur //= 2
    h = hs[-1]
    h = res("mid_block1", h, False, (cur, cur))
    h = attn("mid_attn", h, False, (cur, cur))
    h = res("mid_block2", h, False, (cur, cur))
    for i in reversed(range(nres)):
        sparse = cur >= thr
        for ib in range(nrb + 1):
            h = res(f"up_blocks.{i}.{ib}", torch.cat([h, hs.pop()], dim=1),
                    sparse, (cur, cur))
            if cur in c["attn_resolutions"]:
                h = attn(f"up_attns.{i}.{ib}", h, sparse, (cur, cur))
        if i != 0:
            cur *= 2
            with sparse_region((cur, cur)):
                h = conv(P, f"upsamples.{i - 1}.conv", up2(h))
            h = run.scatter(f"upsamples.{i - 1}", h, (cur, cur), G_MAIN)
    h = swish(run.group_norm("norm_out", h, P["norm_out_scale"],
                             P["norm_out_bias"], G))
    with sparse_region((cur, cur)):
        h = conv(P, "conv_out", h)
    h = run.scatter("conv_out", h, (cur, cur), G_MAIN)
    return to_nhwc(h)
