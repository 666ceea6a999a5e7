"""Plain reference of the Stable Diffusion v1 U-Net (CompVis
``ldm/modules/diffusionmodules/openaimodel.py`` with the v1 inference
config) and of its SIGE sparse step (lmxyy/sige ``stable-diffusion``:
``sige_openaimodel.py``, ``sige_attention.py``), in dense form.

The model: a 3x3 conv in; per level ``num_res_blocks`` resblocks (the
time embedding projected per block and added between the convs, a 1x1
``skip`` where the channels change) each followed at the attention
levels by a spatial transformer (GroupNorm, 1x1 ``proj_in``, per block:
LayerNorm + self-attention, LayerNorm + text cross-attention, LayerNorm +
GEGLU feed-forward, each residual; 1x1 ``proj_out``, residual); a
stride-2 3x3 downsample padded 1; a middle of resblock, transformer,
resblock; the up path with skip concatenations and nearest-2x upsamples;
GroupNorm, SiLU, a 3x3 conv out. GELU is the tanh form and LayerNorm's
epsilon 1e-6, as the JAX package this program ports has them.

The SIGE wiring: every resblock conv and the downsamples and upsamples
have block-6 gathers (the downsample's offset 1), shortcuts and the
transformers' 1x1 convs block-4 gathers; the transformer's self-
attention keys and values come from the whole map (fresh where the step
recomputes, the original's elsewhere); the middle resblocks run dense
with live statistics and the live time embedding, the middle transformer
dense over the original's statistics, conv in and the tail dense.
Transformer depth 1.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from .common import (Pass, attention, conv, layer_norm, linear, sparse_region,
                     swish, timestep_sincos, to_nchw, to_nhwc, tokens,
                     untokens, up2)



def _cfg(cfg: Mapping) -> Dict:
    base = dict(main_block_size=6, shortcut_block_size=4, transformer_block_size=4,
                in_channels=4, model_channels=320, out_channels=4,
                num_res_blocks=2, attention_resolutions=(4, 2, 1),
                channel_mult=(1, 2, 4, 4), num_heads=8, transformer_depth=1,
                context_dim=768, num_groups=32)
    base.update(cfg)
    if base["transformer_depth"] != 1:
        raise ValueError("the reference covers transformer depth 1")
    return base


def _levels(c):
    """(in blocks, out blocks) as lists of (name, kind, cin, cout)."""
    mc, mult, nrb = c["model_channels"], c["channel_mult"], c["num_res_blocks"]
    ins, chans = [], [mc]
    ch, ds = mc, 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            idx = len(ins)
            mods = [(f"in_blocks.{idx}.0", "res", ch, m * mc)]
            ch = m * mc
            if ds in c["attention_resolutions"]:
                mods.append((f"in_blocks.{idx}.1", "attn", ch, ch))
            ins.append(mods)
            chans.append(ch)
        if level != len(mult) - 1:
            idx = len(ins)
            ins.append([(f"in_blocks.{idx}.0", "down", ch, ch)])
            chans.append(ch)
            ds *= 2
    outs = []
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(nrb + 1):
            idx = len(outs)
            ich = chans.pop()
            mods = [(f"out_blocks.{idx}.0", "res", ch + ich, m * mc)]
            ch = m * mc
            if ds in c["attention_resolutions"]:
                mods.append((f"out_blocks.{idx}.{len(mods)}", "attn", ch, ch))
            if level and i == nrb:
                mods.append((f"out_blocks.{idx}.{len(mods)}", "up", ch, ch))
                ds //= 2
            outs.append(mods)
    return ins, outs, ch


def param_shapes(cfg: Mapping) -> Dict[str, tuple]:
    c = _cfg(cfg)
    mc, ted, ctx_dim = c["model_channels"], 4 * c["model_channels"], \
        c["context_dim"]
    S: Dict[str, tuple] = {}

    def lin(name, i, o, bias=True):
        S[name + ".weight"] = (o, i)
        if bias:
            S[name + ".bias"] = (o,)

    def cv(name, i, o, k):
        S[name + ".weight"], S[name + ".bias"] = (o, i, k, k), (o,)

    def norm(name, n):
        S[name + ".weight"], S[name + ".bias"] = (n,), (n,)

    def res(name, i, o):
        norm(name + ".norm1", i)
        cv(name + ".conv1", i, o, 3)
        norm(name + ".norm2", o)
        cv(name + ".conv2", o, o, 3)
        lin(name + ".emb_proj", ted, o)
        if i != o:
            cv(name + ".skip", i, o, 1)

    def attn(name, n):
        norm(name + ".norm", n)
        cv(name + ".proj_in", n, n, 1)
        b = name + ".blocks.0"
        for a in ("attn1", "attn2"):
            src = n if a == "attn1" else ctx_dim
            lin(f"{b}.{a}.to_q", n, n, bias=False)
            lin(f"{b}.{a}.to_k", src, n, bias=False)
            lin(f"{b}.{a}.to_v", src, n, bias=False)
            lin(f"{b}.{a}.to_out", n, n)
        lin(b + ".ff.proj", n, 8 * n)
        lin(b + ".ff.out", 4 * n, n)
        for k in ("norm1", "norm2", "norm3"):
            norm(f"{b}.{k}", n)
        cv(name + ".proj_out", n, n, 1)

    lin("time_dense0", mc, ted)
    lin("time_dense1", ted, ted)
    cv("conv_in", c["in_channels"], mc, 3)
    ins, outs, ch = _levels(c)
    for mods in ins + outs:
        for name, kind, i, o in mods:
            if kind == "res":
                res(name, i, o)
            elif kind == "attn":
                attn(name, o)
            else:
                cv(name + (".op" if kind == "down" else ".conv"), i, o, 3)
    top = ins[-1][0][3]
    res("mid_block1", top, top)
    attn("mid_attn", top)
    res("mid_block2", top, top)
    S["out_norm_scale"], S["out_norm_bias"] = (ch,), (ch,)
    cv("conv_out", ch, c["out_channels"], 3)
    return S


def forward(P: Mapping, cfg: Mapping, x: torch.Tensor, t: torch.Tensor,
            context: torch.Tensor, run: Pass) -> torch.Tensor:
    """x [B, L, L, in] NHWC latents, t [B], context [B, T, context_dim]
    -> [B, L, L, out]."""
    c = _cfg(cfg)
    G_MAIN = (c["main_block_size"], 3, 1, 1)  # block, kernel, stride, offset
    G_DOWN = (c["main_block_size"], 3, 2, 1)
    G_ONE = (c["shortcut_block_size"], 1, 1, 0)
    G_TOK = (c["transformer_block_size"], 1, 1, 0)
    G, nh = c["num_groups"], c["num_heads"]
    emb = timestep_sincos(t, c["model_channels"], cos_first=True,
                          denom_offset=0)
    emb = linear(P, "time_dense1", swish(linear(P, "time_dense0", emb)))

    def norm(name, h, live=False):
        return run.group_norm(name, h, P[name + ".weight"],
                              P[name + ".bias"], G, live=live)

    def res(name, h, sparse, live=False):
        hw = tuple(h.shape[2:])
        cin, cout = h.shape[1], P[name + ".conv1.weight"].shape[0]
        a = conv(P, name + ".conv1", swish(norm(name + ".norm1", h, live)))
        if sparse:
            a = run.scatter(name + ".sg", a, hw, G_MAIN)
        a = a + linear(P, name + ".emb_proj", swish(emb))[:, :, None, None]
        a = conv(P, name + ".conv2", swish(norm(name + ".norm2", a, live)))
        xs = conv(P, name + ".skip", h, padding=0) if cin != cout else h
        if not sparse:
            return a + xs
        if cin != cout:
            return run.block_residual(name + ".join", a, xs, hw, G_MAIN,
                                      G_ONE)
        return run.scatter(name + ".join", a + xs, hw, G_MAIN)

    def transformer(name, h, sparse):
        hw = tuple(h.shape[2:])
        a = conv(P, name + ".proj_in", norm(name + ".norm", h), padding=0)
        if sparse:
            a = run.scatter(name + ".scatter1", a, hw, G_TOK)
        tok = tokens(a)
        b = name + ".blocks.0"
        n1 = layer_norm(P, b + ".norm1", tok)
        tok = linear(P, b + ".attn1.to_out", attention(
            linear(P, b + ".attn1.to_q", n1), linear(P, b + ".attn1.to_k", n1),
            linear(P, b + ".attn1.to_v", n1), nh)) + tok
        n2 = layer_norm(P, b + ".norm2", tok)
        tok = linear(P, b + ".attn2.to_out", attention(
            linear(P, b + ".attn2.to_q", n2),
            linear(P, b + ".attn2.to_k", context),
            linear(P, b + ".attn2.to_v", context), nh)) + tok
        n3 = layer_norm(P, b + ".norm3", tok)
        u, g = linear(P, b + ".ff.proj", n3).chunk(2, dim=-1)
        tok = linear(P, b + ".ff.out", u * F.gelu(g, approximate="tanh")) + tok
        a = conv(P, name + ".proj_out", untokens(tok, hw), padding=0)
        if sparse:
            return run.scatter(name + ".scatter2", a + h, hw, G_TOK)
        return a + h

    def module(name, kind, h):
        hw = tuple(h.shape[2:])
        if kind == "res":
            with sparse_region(hw):
                return res(name, h, True)
        if kind == "attn":
            with sparse_region(hw):
                return transformer(name, h, True)
        if kind == "down":
            with sparse_region((hw[0] // 2, hw[1] // 2)):
                h = conv(P, name + ".op", h, stride=2)
            return run.scatter(name, h, hw, G_DOWN)
        with sparse_region((2 * hw[0], 2 * hw[1])):
            h = conv(P, name + ".conv", up2(h))
        return run.scatter(name, h, (2 * hw[0], 2 * hw[1]), G_MAIN)

    ins, outs, _ = _levels(c)
    h = conv(P, "conv_in", to_nchw(x))
    hs = [h]
    for mods in ins:
        h = hs[-1]
        for name, kind, _, _ in mods:
            h = module(name, kind, h)
        hs.append(h)
    h = res("mid_block1", hs[-1], False, live=True)
    h = transformer("mid_attn", h, False)
    h = res("mid_block2", h, False, live=True)
    for mods in outs:
        h = torch.cat([h, hs.pop()], dim=1)
        for name, kind, _, _ in mods:
            h = module(name, kind, h)
    h = run.group_norm("out_norm", h, P["out_norm_scale"], P["out_norm_bias"],
                       G, live=True)
    return to_nhwc(conv(P, "conv_out", swish(h)))
