"""Plain reference of the Stable Diffusion v1 VAE decoder (CompVis
``ldm/modules/diffusionmodules/model.py`` Decoder) and of its SIGE sparse
step (lmxyy/sige ``stable-diffusion/ldm/modules/diffusionmodules/
sige_model.py``), in dense form.

The model: a 3x3 conv in; a middle of resblock, single-head attention,
resblock; per level, coarse to fine, ``num_res_blocks + 1`` resblocks (a
1x1 ``nin_shortcut`` where the channels change) and a nearest-2x upsample
with a 3x3 conv; GroupNorm, swish, a 3x3 conv out. GroupNorm's epsilon
is 1e-6, as the JAX package this program ports has it.

The SIGE wiring: every resblock conv and upsample conv and the tail conv
have block-6 gathers, shortcuts and the attention's 1x1 convs block-4
gathers; the attention's keys and values cover the whole map (fresh where
the step recomputes, the original's elsewhere); conv in runs dense, the
tail's GroupNorm over the original's statistics.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .common import (Pass, attention, conv, sparse_region, swish, to_nchw,
                     to_nhwc, tokens, untokens, up2)



def _cfg(cfg: Mapping) -> Dict:
    base = dict(main_block_size=6, shortcut_block_size=4, attn_block_size=4,
                ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                attn_resolutions=(), out_ch=3, z_channels=4, resolution=512,
                num_groups=32)
    base.update(cfg)
    if tuple(base["attn_resolutions"]):
        raise ValueError("the reference covers SD v1's decoder: attention "
                         "in the middle only")
    return base


def param_shapes(cfg: Mapping) -> Dict[str, tuple]:
    c = _cfg(cfg)
    S: Dict[str, tuple] = {}

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

    mult = tuple(c["ch_mult"])
    bi = c["ch"] * mult[-1]
    cv("conv_in", c["z_channels"], bi, 3)
    res("mid_block1", bi, bi)
    norm("mid_attn.norm", bi)
    for k in ("q", "k", "v", "proj_out"):
        cv(f"mid_attn.{k}", bi, bi, 1)
    res("mid_block2", bi, bi)
    for i in reversed(range(len(mult))):
        bo = c["ch"] * mult[i]
        for ib in range(c["num_res_blocks"] + 1):
            res(f"up_blocks.{i}.{ib}", bi, bo)
            bi = bo
        if i != 0:
            cv(f"upsamples.{i - 1}.conv", bi, bi, 3)
    S["norm_out_scale"], S["norm_out_bias"] = (bi,), (bi,)
    cv("conv_out", bi, c["out_ch"], 3)
    return S


def forward(P: Mapping, cfg: Mapping, z: torch.Tensor,
            run: Pass) -> torch.Tensor:
    """z [B, L, L, z_channels] NHWC -> image [B, 8L, 8L, out_ch]."""
    c = _cfg(cfg)
    G_MAIN = (c["main_block_size"], 3, 1, 1)  # block, kernel, stride, offset
    G_ONE = (c["shortcut_block_size"], 1, 1, 0)
    G_TOK = (c["attn_block_size"], 1, 1, 0)
    G = c["num_groups"]

    def norm(name, h):
        return run.group_norm(name, h, P[name + ".weight"],
                              P[name + ".bias"], G)

    def res(name, h):
        with sparse_region(tuple(h.shape[2:])):
            return _res(name, h)

    def _res(name, h):
        hw = tuple(h.shape[2:])
        cin, cout = h.shape[1], P[name + ".conv1.weight"].shape[0]
        a = conv(P, name + ".conv1", swish(norm(name + ".norm1", h)))
        a = run.scatter(name + ".sg", a, hw, G_MAIN)
        a = conv(P, name + ".conv2", swish(norm(name + ".norm2", a)))
        if cin != cout:
            xs = conv(P, name + ".nin_shortcut", h, padding=0)
            return run.block_residual(name + ".join", a, xs, hw, G_MAIN,
                                      G_ONE)
        return run.scatter(name + ".join", a + h, hw, G_MAIN)

    def attn(name, h):
        with sparse_region(tuple(h.shape[2:])):
            return _attn(name, h)

    def _attn(name, h):
        hw = tuple(h.shape[2:])
        a = norm(name + ".norm", h)
        q = conv(P, name + ".q", a, padding=0)
        k = run.scatter(name + ".k", conv(P, name + ".k", a, padding=0), hw,
                        G_TOK)
        v = run.scatter(name + ".v", conv(P, name + ".v", a, padding=0), hw,
                        G_TOK)
        o = untokens(attention(tokens(q), tokens(k), tokens(v), 1), hw)
        o = conv(P, name + ".proj_out", o, padding=0)
        return run.scatter(name + ".out", o + h, hw, G_TOK)

    mult = tuple(c["ch_mult"])
    h = conv(P, "conv_in", to_nchw(z))
    h = res("mid_block1", h)
    h = attn("mid_attn", h)
    h = res("mid_block2", h)
    for i in reversed(range(len(mult))):
        for ib in range(c["num_res_blocks"] + 1):
            h = res(f"up_blocks.{i}.{ib}", h)
        if i != 0:
            hw = tuple(h.shape[2:])
            with sparse_region((2 * hw[0], 2 * hw[1])):
                h = conv(P, f"upsamples.{i - 1}.conv", up2(h))
            h = run.scatter(f"upsamples.{i - 1}", h, (2 * hw[0], 2 * hw[1]),
                            G_MAIN)
    h = swish(run.group_norm("norm_out", h, P["norm_out_scale"],
                             P["norm_out_bias"], G))
    with sparse_region(tuple(h.shape[2:])):
        out = conv(P, "conv_out", h)
    h = run.scatter("conv_out", out, tuple(h.shape[2:]), G_MAIN)
    return to_nhwc(h)
