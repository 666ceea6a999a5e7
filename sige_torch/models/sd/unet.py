"""Stable Diffusion U-Net (openaimodel architecture) with SIGE wiring — the
port of ``sige_tpu.models.sd.unet``.

Reference: stable-diffusion/ldm/modules/diffusionmodules/
sige_openaimodel.py + ldm/modules/sige_attention.py.

The sparse design:
  * resblocks fold GroupNorm + SiLU into the gathers (main block 6,
    shortcut block 4; reference: sige_openaimodel.py:79-81), the additive
    time embedding absorbed into the cached norm2 shift;
  * the SpatialTransformer keeps attention *global* while queries stay
    local: the proj_in tiles are scattered onto the cached full map to
    form the K/V tokens, the queries are the tile tokens, and the text
    cross-attention reuses K/V projections cached by the full pass
    (reference: sige_attention.py:30-42, 134-185);
  * the middle block runs dense with live statistics (reference:
    sige_openaimodel.py:370-396), over cached text K/V in sparse mode.

Window-resident chains (``window_chain``, layout="window"): resblocks,
skip concatenations, resamples and the transformers thread
:class:`~sige_torch.nn.module.WindowState` so full maps never
materialize between blocks. The transformer stays global through
*masked stale-K/V attention*: the full pass caches each block's projected
K/V token maps; a sparse pass projects only the window tokens and attends
over [stale full map ++ fresh window] with additive -1e9 biases that keep
exactly one token per spatial position (stale where unedited, fresh where
edited) — the token set of the scatter-updated map, without building it.

K/V-cached transformers (``kv_cache_min_tokens``, off by default): at a
level whose map has at least that many tokens, the full pass caches each
block's projected K/V token maps through a pair of scatters, and a sparse
pass projects only the edited tokens and scatters them over those caches
(exact: LayerNorm and the projections are per-token), in place of
scattering the features once and reprojecting the whole map. For depth
> 1 the deeper blocks' K/V of unedited tokens are the full pass's, as in
``sige_tpu`` (the reference's stale full map makes the same
approximation). Such a level writes no ``k1_*`` caches, so in the window
layout it takes the non-chain path.

Cache slots and ``sparse_update``: every cache is per slot (the engine
binds it), the text and ``k1_*`` K/V caches too; under ``sparse_update``
the window chains step aside (a chain never forms the scattered maps the
caches take), so the transformers scatter their features, and the
K/V-cached levels their K/V, into the slot; the ``k1_*`` caches keep the
full pass's projections, as in ``sige_tpu``.

Module names follow ``sige_tpu``'s flax names (``in_blocks_1_1`` there is
``in_blocks.1.1`` here), so the weight bridge and the plan trees map one
to one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.module import (Gather, Scatter, SIGECtx, SIGEConv2d, SIGEModule,
                          WindowState, add_dense_macs, add_macs)
from ...nn.norm import group_norm_with_affine
from ...ops.attention import masked_mha, mha, stale_fresh_biases
from ...ops.window import window_slice
from ..blocks import (FoldedGroupNorm, ResBlock, SIGEDownsample, SIGEUpsample,
                      affine, swish, to_map)


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    """SD v1 defaults (reference: stable-diffusion/configs/sige.yaml:50-66).
    The fields and defaults are ``sige_tpu``'s."""

    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)  # downsample factors
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    num_groups: int = 32
    main_block_size: Optional[int] = 6
    shortcut_block_size: Optional[int] = 4
    transformer_block_size: Optional[int] = 4
    #: latent resolution below which levels run dense (0: every level
    #: sparse, the reference's wiring)
    sparse_resolution_threshold: int = 0
    #: token count at/above which the transformer's self-attention K/V
    #: come from scatter-updated caches instead of reprojecting the full
    #: map each sparse call (off by default)
    kv_cache_min_tokens: int = 1 << 30
    #: window-layout chains through resblocks, skip concatenations,
    #: resamples and transformers (masked stale-K/V attention)
    window_chain: bool = True
    cache_slots: int = 1


def sd_timestep_embedding(t: torch.Tensor, dim: int,
                          max_period: float = 10000.0) -> torch.Tensor:
    """openai-convention embedding: cat([cos, sin]), freqs over half
    (reference: ldm/modules/diffusionmodules/util.py timestep_embedding)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class SIGESDResBlock(ResBlock):
    """Reference: sige_openaimodel.py:67-224 (use_scale_shift_norm=False in
    SD v1: the additive time embedding folds in as a pre-shift).

    ``live_dense``: run dense with LIVE statistics in sparse mode — the
    reference's middle-block resblocks are plain ResBlocks that recompute
    GroupNorm statistics on the scatter-updated map and add the live time
    embedding (reference: sige_openaimodel.py:370-396)."""

    def __init__(self, cfg: SDUNetConfig, channels: int, out_channels: int,
                 support_sparse: bool = True, live_dense: bool = False):
        super().__init__(channels, out_channels, cfg.num_groups,
                         cfg.main_block_size if support_sparse else None,
                         cfg.shortcut_block_size, cfg.window_chain,
                         shortcut_name="skip")
        self.live_dense = live_dense
        self.emb_proj = nn.Linear(4 * cfg.model_channels, out_channels)

    def forward(self, x, emb, ctx: SIGECtx):
        def temb():
            add_dense_macs(ctx, emb, self.out_channels)
            return self.emb_proj(swish(emb))

        return self._run(x, ctx, temb,
                         live=self.live_dense and ctx.mode == "sparse")


class SIGECrossAttention(SIGEModule):
    """Cross-attention whose K/V (text projections) are cached by the full
    pass and reused by the sparse pass (reference: sige_attention.py:12-63)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.query_dim, self.heads, self.dim_head = query_dim, heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, ctx: SIGECtx, context=None):
        inner = self.heads * self.dim_head
        q = self.to_q(x)
        add_dense_macs(ctx, x, inner)
        src = x if context is None else context
        if ctx.mode in ("dense", "full"):
            k, v = self.to_k(src), self.to_v(src)
            add_dense_macs(ctx, src, inner)
            add_dense_macs(ctx, src, inner)
            if ctx.mode == "full":
                self.cache["k"], self.cache["v"] = k, v
        else:
            k, v = self.cache["k"], self.cache["v"]
        B, N, _ = q.shape
        out = mha(q, k, v, self.heads, self.dim_head)
        add_macs(ctx, 2 * B * N * k.shape[1] * inner)
        add_dense_macs(ctx, out, self.query_dim)
        return self.to_out(out)


class _SelfAttention(nn.Module):
    """Self-attention for attn1, split into ``kv`` and ``attend`` so the
    transformer can take K/V from elsewhere (the scattered full map, or
    the cached stale map plus the fresh window)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.query_dim, self.heads, self.dim_head = query_dim, heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def kv(self, src, ctx: SIGECtx):
        """K/V projections of ``src`` tokens ([B, M, C] -> 2 x [B, M,
        inner])."""
        inner = self.heads * self.dim_head
        add_dense_macs(ctx, src, inner)
        add_dense_macs(ctx, src, inner)
        return self.to_k(src), self.to_v(src)

    def _q(self, x, ctx: SIGECtx):
        add_dense_macs(ctx, x, self.heads * self.dim_head)
        return self.to_q(x)

    def _out(self, out, ctx: SIGECtx):
        add_dense_macs(ctx, out, self.query_dim)
        return self.to_out(out)

    def attend(self, x, k, v, ctx: SIGECtx):
        """Multi-head attention of ``x`` queries over (k, v) tokens."""
        q = self._q(x, ctx)
        B, N, inner = q.shape
        out = mha(q, k, v, self.heads, self.dim_head)
        add_macs(ctx, 2 * B * N * k.shape[1] * inner)
        return self._out(out, ctx)

    def forward(self, x, ctx: SIGECtx):
        return self.attend(x, *self.kv(x, ctx), ctx)

    def attend_masked(self, x, ks, vs, kf, vf, bias_s, bias_f,
                      ctx: SIGECtx):
        """Attention over [stale full map ++ fresh window] K/V with
        additive biases keeping exactly one token per spatial position."""
        q = self._q(x, ctx)
        B, N, inner = q.shape
        out = masked_mha(q, ks, vs, kf, vf, bias_s, bias_f, self.heads,
                         self.dim_head)
        add_macs(ctx, 2 * B * N * (ks.shape[1] + kf.shape[1]) * inner)
        return self._out(out, ctx)


class _GEGLUFeedForward(nn.Module):
    """Gated-GELU feed-forward (reference: ldm/modules/attention.py
    FeedForward with glu=True); the GELU is the tanh form, as
    ``jax.nn.gelu``'s default."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.dim = dim
        self.proj = nn.Linear(dim, 2 * dim * mult)
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x, ctx: SIGECtx):
        proj = self.proj(x)
        add_dense_macs(ctx, x, self.proj.out_features)
        a, g = proj.chunk(2, dim=-1)
        add_dense_macs(ctx, a, self.dim)
        return self.out(a * F.gelu(g, approximate="tanh"))


class SIGEBasicTransformerBlock(nn.Module):
    """Self-attention -> text cross-attention (cached K/V) -> GEGLU FF
    (reference: sige_attention.py:66-88). LayerNorm eps is flax's 1e-6."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = _SelfAttention(dim, n_heads, d_head)
        self.attn2 = SIGECrossAttention(dim, context_dim, n_heads, d_head)
        self.ff = _GEGLUFeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, ctx: SIGECtx, kv1=None, context=None):
        """``kv1``: precomputed (k, v) token maps for the self-attention;
        None -> self-contained self-attention."""
        n1 = self.norm1(x)
        x = (self.attn1(n1, ctx) if kv1 is None
             else self.attn1.attend(n1, *kv1, ctx)) + x
        x = self.attn2(self.norm2(x), ctx, context=context) + x
        return self.ff(self.norm3(x), ctx) + x


class SIGESpatialTransformer(SIGEModule):
    """Reference: sige_attention.py:91-185."""

    def __init__(self, cfg: SDUNetConfig, channels: int, n_heads: int,
                 d_head: int, depth: int = 1, support_sparse: bool = True):
        super().__init__()
        self.cfg = cfg
        self.sparse_ok = (support_sparse
                          and cfg.transformer_block_size is not None)
        inner = n_heads * d_head
        self.inner = inner
        self.norm = FoldedGroupNorm(channels, cfg.num_groups)
        self.proj_in = SIGEConv2d(channels, inner, kernel_size=1, padding=0,
                                  tile_input=self.sparse_ok)
        self.blocks = nn.ModuleList([
            SIGEBasicTransformerBlock(inner, n_heads, d_head,
                                      cfg.context_dim)
            for _ in range(depth)])
        self.proj_out = SIGEConv2d(inner, channels, kernel_size=1, padding=0,
                                   tile_input=self.sparse_ok)
        if self.sparse_ok:
            self.gather = Gather(block_size=cfg.transformer_block_size,
                                 kernel_size=1, conv_stride=1, conv_padding=0)
            # per block, the K/V scatters of the K/V-cached levels: the
            # full pass caches the projected K/V maps, a sparse pass
            # scatters the edited tokens' projections over them
            self.kv_scatters = nn.ModuleList([
                nn.ModuleList([Scatter(self.gather), Scatter(self.gather)])
                for _ in range(depth)])
            # scatter1: the fresh proj_in tokens over the cached map (the
            # K/V source of the other levels); scatter2: the output join
            self.scatter1 = Scatter(self.gather)
            self.scatter2 = Scatter(self.gather)

    def forward(self, x, ctx: SIGECtx, context=None):
        if (ctx.mode == "sparse" and self.sparse_ok and self.cfg.window_chain
                and not ctx.sparse_update and self.gather.planned_window()
                and "k1_0" in self.cache):
            return self._chain_window(x, ctx, context)
        x = to_map(x)
        B, H, W, _ = x.shape
        x_in = x
        sparse = ctx.mode == "sparse"

        if not sparse:
            h = self.gather(x, ctx) if self.sparse_ok else x
            h, _, _ = self.norm(h, ctx)
        else:
            _, s, b = self.norm(x, ctx)
            h = (self.gather(x, ctx, scale=s, shift=b) if self.sparse_ok
                 else affine(x, s, b))
        h = self.proj_in(h, ctx)
        h_shape = h.shape
        # tile layout: [B*K, bs, bs, C]; window: [B, WH, WW, C]
        tok = h.reshape(B, -1, self.inner)

        kv_cached = self.sparse_ok and H * W >= self.cfg.kv_cache_min_tokens
        full_tok = None
        if self.sparse_ok and not kv_cached and ctx.mode != "dense":
            # one feature scatter; K/V reprojected from the full map
            full_tok = self.scatter1(h, ctx).reshape(B, H * W, self.inner)

        for i, block in enumerate(self.blocks):
            if (self.sparse_ok and self.cfg.window_chain and not kv_cached
                    and ctx.mode == "full"):
                # cache this block's K/V token maps for the chain path's
                # masked stale-K/V attention (LayerNorm and the
                # projections are per-token)
                kv1 = block.attn1.kv(block.norm1(tok), ctx)
                self.cache[f"k1_{i}"], self.cache[f"v1_{i}"] = kv1
            elif kv_cached and ctx.mode != "dense":
                # K/V over the full token map from the K/V caches: the
                # full pass projects every token and caches the maps, a
                # sparse pass projects the edited tokens only and scatters
                # them over the caches
                kt, vt = block.attn1.kv(block.norm1(tok), ctx)
                sc_k, sc_v = self.kv_scatters[i]
                kv1 = tuple(
                    sc(t.reshape(*h_shape[:-1], self.inner), ctx).reshape(
                        B, H * W, self.inner)
                    for sc, t in ((sc_k, kt), (sc_v, vt)))
            elif full_tok is not None and sparse:
                kv1 = block.attn1.kv(block.norm1(full_tok), ctx)
            else:
                kv1 = None
            tok = block(tok, ctx, kv1=kv1, context=context)

        h = tok.reshape(h_shape)
        h = self.proj_out(h, ctx)
        if self.sparse_ok:
            return self.scatter2(h, ctx, residual=x_in)
        return h + x_in

    def _chain_window(self, x, ctx: SIGECtx, context) -> WindowState:
        """Window-resident sparse path: per-token ops run on the carried
        canonical window (the gather is kernel-1, so its extraction window
        IS the canonical window); self-attention stays global through
        masked stale-K/V. No full map is read or written."""
        cache = self.scatter2.cache["original"]
        res = tuple(cache.shape[1:3])
        org, cov = self.gather.read_wsc(res)
        WH, WW = cov.shape
        xw = x.win if isinstance(x, WindowState) else window_slice(
            x, org, (WH, WW))
        B = xw.shape[0]
        _, s, b = self.norm(None, ctx)
        h = self.proj_in(affine(xw, s, b), ctx)
        tok = h.reshape(B, WH * WW, self.inner)

        bias_s, bias_f = stale_fresh_biases(cov, org, res)

        for i, block in enumerate(self.blocks):
            n1 = block.norm1(tok)
            kf, vf = block.attn1.kv(n1, ctx)
            tok = block.attn1.attend_masked(
                n1, self.cache[f"k1_{i}"], self.cache[f"v1_{i}"], kf, vf,
                bias_s, bias_f, ctx) + tok
            tok = block.attn2(block.norm2(tok), ctx, context=context) + tok
            tok = block.ff(block.norm3(tok), ctx) + tok

        h = self.proj_out(tok.reshape(B, WH, WW, self.inner), ctx)
        y0w = window_slice(cache, org, (WH, WW))
        return WindowState(torch.where(cov[None, :, :, None], h + xw, y0w),
                           cache, org)


class SIGESDDownsample(SIGEDownsample):
    """Stride-2 conv, symmetric padding 1, named ``op``
    (reference: sige_openaimodel.py:14-33)."""

    conv_name = "op"

    def __init__(self, cfg: SDUNetConfig, channels: int,
                 support_sparse: bool = True):
        super().__init__(channels,
                         cfg.main_block_size if support_sparse else None,
                         padding=1)


class SIGESDUpsample(SIGEUpsample):
    """Nearest 2x + conv (reference: sige_openaimodel.py:36-64)."""

    def __init__(self, cfg: SDUNetConfig, channels: int,
                 support_sparse: bool = True):
        super().__init__(channels,
                         cfg.main_block_size if support_sparse else None)


class SIGESDUNet(SIGEModule):
    """Reference: sige_openaimodel.py:226-451 (structure mirrors
    openaimodel.UNetModel). ``forward(x, t, context, ctx)`` with x
    [B, H, W, in_channels] latents, t [B] timesteps and context
    [B, seq, context_dim] text embeddings."""

    def __init__(self, cfg: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_dense0 = nn.Linear(mc, ted)
        self.time_dense1 = nn.Linear(ted, ted)
        self.conv_in = SIGEConv2d(cfg.in_channels, mc, kernel_size=3,
                                  padding=1, tile_input=False)

        def transformer(ch, sparse=True):
            nh = cfg.num_heads
            return SIGESpatialTransformer(cfg, ch, nh, ch // nh,
                                          cfg.transformer_depth, sparse)

        latent_res = 64  # canonical SD v1 latent; only the ds ratio matters

        def sparse_at(ds_):
            return (latent_res // ds_) >= cfg.sparse_resolution_threshold

        in_blocks, in_kinds = [], []   # parallel lists in traversal order
        input_chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                mods = [SIGESDResBlock(cfg, ch, mult * mc, sparse_at(ds))]
                kinds = ["res"]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    mods.append(transformer(ch, sparse_at(ds)))
                    kinds.append("attn")
                in_blocks.append(nn.ModuleList(mods))
                in_kinds.append(kinds)
                input_chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                in_blocks.append(nn.ModuleList(
                    [SIGESDDownsample(cfg, ch, sparse_at(ds))]))
                in_kinds.append(["down"])
                input_chans.append(ch)
                ds *= 2
        self.in_blocks = nn.ModuleList(in_blocks)
        self._in_kinds = in_kinds

        self.mid_block1 = SIGESDResBlock(cfg, ch, ch, support_sparse=False,
                                         live_dense=True)
        self.mid_attn = transformer(ch, sparse=False)
        self.mid_block2 = SIGESDResBlock(cfg, ch, ch, support_sparse=False,
                                         live_dense=True)

        out_blocks, out_kinds = [], []
        chans = list(input_chans)
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                ich = chans.pop()
                mods = [SIGESDResBlock(cfg, ch + ich, mult * mc,
                                       sparse_at(ds))]
                kinds = ["res"]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    mods.append(transformer(ch, sparse_at(ds)))
                    kinds.append("attn")
                if level and i == cfg.num_res_blocks:
                    mods.append(SIGESDUpsample(cfg, ch, sparse_at(ds)))
                    kinds.append("up")
                    ds //= 2
                out_blocks.append(nn.ModuleList(mods))
                out_kinds.append(kinds)
        self.out_blocks = nn.ModuleList(out_blocks)
        self._out_kinds = out_kinds

        self.out_norm_scale = nn.Parameter(torch.ones(ch))
        self.out_norm_bias = nn.Parameter(torch.zeros(ch))
        self.conv_out = SIGEConv2d(ch, cfg.out_channels, kernel_size=3,
                                   padding=1, tile_input=False)

    @staticmethod
    def _run_blocks(mods, kinds, h, emb, context, ctx):
        for kind, mod in zip(kinds, mods):
            if kind == "res":
                h = mod(h, emb, ctx)
            elif kind == "attn":
                h = mod(h, ctx, context=context)
            else:
                h = mod(h, ctx)
        return h

    def forward(self, x, t, context, ctx: SIGECtx):
        cfg = self.cfg
        # the time embedding is needed in every mode: the live middle
        # resblocks add it in sparse mode too (reference:
        # openaimodel.py:715-730)
        emb = sd_timestep_embedding(t, cfg.model_channels)
        add_dense_macs(ctx, emb, 4 * cfg.model_channels)
        emb = self.time_dense0(emb)
        add_dense_macs(ctx, emb, 4 * cfg.model_channels)
        emb = self.time_dense1(swish(emb)).to(x.dtype)

        hs = [self.conv_in(x, ctx)]
        for mods, kinds in zip(self.in_blocks, self._in_kinds):
            hs.append(self._run_blocks(mods, kinds, hs[-1], emb, context, ctx))

        h = self.mid_block1(hs[-1], emb, ctx)
        h = self.mid_attn(h, ctx, context=context)
        h = self.mid_block2(h, emb, ctx)

        for mods, kinds in zip(self.out_blocks, self._out_kinds):
            # the skip join goes in as a tuple: the window-chain path
            # extends both parts window-resident; other paths concatenate
            h = self._run_blocks(mods, kinds, (h, hs.pop()), emb, context, ctx)

        h, _, _ = group_norm_with_affine(
            to_map(h), cfg.num_groups, self.out_norm_scale,
            self.out_norm_bias, eps=1e-6)
        return self.conv_out(swish(h), ctx)
