"""Plain reference of Stable Diffusion XL's base U-Net (Podell et al. 2023,
arXiv:2307.01952; Stability-AI generative-models
``sgm/modules/diffusionmodules/openaimodel.py`` with
``configs/inference/sd_xl_base.yaml``'s ``network_config``) and of its SIGE
sparse step, in dense form.

The model is :mod:`.sd_unet`'s widened: each level's transformers hold
that level's ``transformer_depth`` blocks (SDXL: none at 128², 2 at 64²,
10 at 32², and the middle the last level's 10), heads are ``num_head_channels`` wide
(heads = channels / 64), and the label embedding (Linear ``adm_in_channels``
-> 4 x ``model_channels``, SiLU, Linear) of ``y``, the pooled text vector
with the size conditioning, is added to the time embedding.

The SIGE wiring is :mod:`.sd_unet`'s, with one rule for depth: in a sparse
step block i's self-attention keys and values come from block i's input
over the whole map, fresh where the step recomputes and the original's
block-i input elsewhere, and block i's output outside those positions is
the original's (a scatter of the token map after each block, with the
transformer's block-4, kernel-1 gather). The middle runs dense over the
original's statistics, its resblocks with live statistics.

Departures from the published model, each the program's convention:

* GELU is the tanh form and LayerNorm's epsilon 1e-6 (as :mod:`.sd_unet`);
* ``proj_in`` and ``proj_out`` are 1x1 convs, SDXL's
  ``use_linear_in_transformer`` Linear layers in conv form: the same
  arithmetic per token, a [o, i, 1, 1] weight in place of [o, i];
* the SIGE wiring above, which changes the sparse step and not the full
  pass.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from .common import (Pass, attention, conv, layer_norm, linear, sparse_region,
                     swish, timestep_sincos, to_nchw, to_nhwc, tokens,
                     untokens, up2)
from .sd_unet import _levels


def _cfg(cfg: Mapping) -> Dict:
    base = dict(main_block_size=6, shortcut_block_size=4,
                transformer_block_size=4, in_channels=4, model_channels=320,
                out_channels=4, num_res_blocks=2, attention_resolutions=(4, 2),
                channel_mult=(1, 2, 4), num_head_channels=64,
                transformer_depth=(1, 2, 10),
                context_dim=2048, adm_in_channels=2816, num_groups=32,
                sparse_resolution_threshold=0)
    base.update(cfg)
    if base["sparse_resolution_threshold"]:
        raise ValueError("the reference covers every level sparse")
    return base


def _depth(c, level: int) -> int:
    d = c["transformer_depth"]
    return d if isinstance(d, int) else d[level]


def _heads(c, channels: int) -> int:
    return channels // c["num_head_channels"]


def _depths(c) -> Dict[str, int]:
    """Each transformer's depth by name: an in block's level is its index
    over (res blocks + 1), an out block's counts from the top."""
    ins, outs, _ = _levels(c)
    per, top = c["num_res_blocks"] + 1, len(c["channel_mult"]) - 1
    out = {}
    for levels, blocks in (((lambda j: j // per), ins),
                           ((lambda j: top - j // per), outs)):
        for j, mods in enumerate(blocks):
            for name, kind, _, _ in mods:
                if kind == "attn":
                    out[name] = _depth(c, levels(j))
    out["mid_attn"] = _depth(c, top)
    return out


def param_shapes(cfg: Mapping) -> Dict[str, tuple]:
    c = _cfg(cfg)
    mc, ted, ctx_dim = c["model_channels"], 4 * c["model_channels"], \
        c["context_dim"]
    depths = _depths(c)
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
        for j in range(depths[name]):
            b = f"{name}.blocks.{j}"
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
    if c["adm_in_channels"]:
        lin("label_dense0", c["adm_in_channels"], ted)
        lin("label_dense1", ted, ted)
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
            context: torch.Tensor, y: torch.Tensor, run: Pass) -> torch.Tensor:
    """x [B, L, L, in] NHWC latents, t [B], context [B, T, context_dim],
    y [B, adm_in_channels] -> [B, L, L, out]."""
    c = _cfg(cfg)
    G_MAIN = (c["main_block_size"], 3, 1, 1)  # block, kernel, stride, offset
    G_DOWN = (c["main_block_size"], 3, 2, 1)
    G_ONE = (c["shortcut_block_size"], 1, 1, 0)
    G_TOK = (c["transformer_block_size"], 1, 1, 0)
    G = c["num_groups"]
    depths = _depths(c)
    emb = timestep_sincos(t, c["model_channels"], cos_first=True,
                          denom_offset=0)
    emb = linear(P, "time_dense1", swish(linear(P, "time_dense0", emb)))
    if c["adm_in_channels"]:
        emb = emb + linear(P, "label_dense1",
                           swish(linear(P, "label_dense0", y)))

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

    def block(b, tok, nh):
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
        return linear(P, b + ".ff.out", u * F.gelu(g, approximate="tanh")) \
            + tok

    def transformer(name, h, sparse):
        hw = tuple(h.shape[2:])
        nh, depth = _heads(c, h.shape[1]), depths[name]
        a = conv(P, name + ".proj_in", norm(name + ".norm", h), padding=0)
        if sparse:
            a = run.scatter(name + ".scatter1", a, hw, G_TOK)
        tok = tokens(a)
        for j in range(depth):
            tok = block(f"{name}.blocks.{j}", tok, nh)
            if sparse and j < depth - 1:  # the next block's input
                tok = tokens(run.scatter(f"{name}.blocks.{j}.scatter",
                                         untokens(tok, hw), hw, G_TOK))
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
