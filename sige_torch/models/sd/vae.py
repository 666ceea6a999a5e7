"""Stable Diffusion VAE (AutoencoderKL) with SIGE wiring — the port of
``sige_tpu.models.sd.vae``.

Reference: stable-diffusion/ldm/modules/diffusionmodules/sige_model.py,
model.py:180-264, ldm/models/sige_autoencoder.py.

The mid block's attention is sparse-query global attention: Q comes from
the active tiles only, K/V are scattered onto the cached full maps, so
the edited positions attend over global context (reference:
model.py:180-253). In the window layout with ``window_chain`` it is the
masked stale-K/V form of the SD U-Net's transformers: Q/K/V project only
the carried window and attend over [cached K/V maps ++ fresh window].
SD v1's VAE has no other attention (``attn_resolutions = ()``).

The opt-in tile-resident chain (``tile_chain``, tile layout): resblocks
with an identity shortcut hand on a :class:`~sige_torch.nn.module.TileState`
(their output at the shared gather positions) instead of a full map, so
consecutive such blocks never materialize the map between them; the
first consumer that needs the map (a resample, the attention, a block
whose channels change, the tail) materializes it.

Under ``sparse_update`` every chain (the window chains, the stem's and
the attention's, and the tile chain) steps aside: a chain never forms the
scattered maps the caches take.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ...nn.module import (Gather, Scatter, SIGECtx, SIGEConv2d, SIGEModule,
                          TileState, WindowState, add_macs, chain_rel)
from ...nn.norm import group_norm_with_affine
from ...ops import gather_tiles, scatter_gather_residual_tiles
from ...ops.attention import masked_mha, mha, stale_fresh_biases
from ...ops.window import window_chain_extend, window_slice
from ..blocks import (FoldedGroupNorm, FoldedNormAffine, ResBlock,
                      SIGEDownsample, SIGEUpsample, affine, swish, to_map)


@dataclasses.dataclass(frozen=True)
class SDVAEConfig:
    """SD v1 ddconfig (reference: stable-diffusion/configs/sige.yaml:13-27).
    The fields and defaults are ``sige_tpu``'s."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    double_z: bool = True
    resolution: int = 256
    num_groups: int = 32
    main_block_size: Optional[int] = 6
    shortcut_block_size: Optional[int] = 4
    attn_block_size: Optional[int] = 4
    #: keep identity-shortcut resblock chains tile-resident in sparse
    #: mode, tile layout (off by default; no reference counterpart)
    tile_chain: bool = False
    #: window-layout chains through resblocks, upsamples and the mid
    #: attention (masked stale-K/V)
    window_chain: bool = True
    #: SIGE-ify the decoder tail (norm_out's affine folded from the full
    #: pass, the conv_out windowed or tiled) and the encoder stem
    sige_tail: bool = True
    cache_slots: int = 1


class SIGEVAEResnetBlock(ResBlock):
    """Reference: sige_model.py:10-139 (no time embedding at inference)."""

    def __init__(self, cfg: SDVAEConfig, in_channels: int, out_channels: int,
                 support_sparse: bool = True):
        super().__init__(in_channels, out_channels, cfg.num_groups,
                         cfg.main_block_size if support_sparse else None,
                         cfg.shortcut_block_size, cfg.window_chain)
        self.tile_chain = cfg.tile_chain

    @property
    def _chainable(self) -> bool:
        """Whether the block joins a tile-resident chain (identity
        shortcut, sparse main path)."""
        return (self.tile_chain and self.main_sparse
                and self.in_channels == self.out_channels)

    def forward(self, x, ctx: SIGECtx):
        if (ctx.mode == "sparse" and self._chainable and not ctx.sparse_update
                and not self.main_gather.planned_window()):
            return self._chain_sparse(x, ctx)
        out = self._run(x, ctx)
        if self._chainable and ctx.mode == "full":
            # plan products for the tile-resident sparse path
            self.main_gather.request_sg(out.shape[1:3])
            self.main_gather.request_pixsrc(out.shape[1:3])
        return out

    def _chain_sparse(self, x, ctx: SIGECtx) -> TileState:
        """Tile-resident sparse path: the block's input and output stay at
        the gather positions (every block of a chain shares its
        resolution's gather plan), norm1 and swish applied explicitly on
        the raw tiles, the residual join evaluated there too."""
        g = self.main_gather
        geom = g.geom
        y0 = self.join.cache["original"]
        res = tuple(y0.shape[1:3])
        sg_src, sg_flat = g.read_sg(res)
        pix_box, pix_org = g.read_pixsrc(res)
        if isinstance(x, TileState):
            T = x.tiles
        else:  # raw tiles, without the gather's fused epilogue
            T = gather_tiles(x, g.plan["indices"], g.plan["count"], geom)
        B = y0.shape[0]
        K = T.shape[0] // B
        bh, bw = geom.block_size
        ok = (sg_src > -2).reshape(1, K, bh, bw, 1)

        _, s1, b1 = self.norm1(T, ctx)
        h = swish(T.reshape(B, K, bh, bw, -1) * s1[:, None, None, None, :]
                  + b1[:, None, None, None, :])
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        h = torch.where(ok, h, zero).reshape(B * K, bh, bw, -1)
        h = self.conv1(h, ctx)
        _, s2, b2 = self.norm2(h, ctx)
        h = self.sg(h, ctx, scale=s2, shift=b2)
        h = self.conv2(h, ctx)
        T2 = scatter_gather_residual_tiles(h, y0, T, sg_src, sg_flat, geom)
        return TileState(T2, y0, pix_box, pix_org, geom)


class SIGEVAEAttnBlock(SIGEModule):
    """Sparse-query / dense-K,V global attention (reference:
    model.py:180-253): Q from the active tiles only, K/V scattered onto
    the cached full maps."""

    def __init__(self, cfg: SDVAEConfig, channels: int,
                 support_sparse: bool = True):
        super().__init__()
        self.window_chain = cfg.window_chain
        self.channels = C = channels
        self.sparse_ok = support_sparse and cfg.attn_block_size is not None
        self.norm = FoldedGroupNorm(C, cfg.num_groups)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, SIGEConv2d(C, C, kernel_size=1, padding=0,
                                           tile_input=self.sparse_ok))
        if self.sparse_ok:
            self.gather = Gather(block_size=cfg.attn_block_size,
                                 kernel_size=1, conv_stride=1, conv_padding=0)
            self.k_scatter = Scatter(self.gather)
            self.v_scatter = Scatter(self.gather)
            self.out_scatter = Scatter(self.gather)

    def forward(self, x, ctx: SIGECtx):
        if (ctx.mode == "sparse" and self.sparse_ok and self.window_chain
                and not ctx.sparse_update and self.gather.planned_window()):
            return self._chain_window(x, ctx)
        x = to_map(x)
        C = self.channels
        B = x.shape[0]
        sparse = ctx.mode == "sparse"
        if not sparse:
            h = self.gather(x, ctx) if self.sparse_ok else x
            h, _, _ = self.norm(h, ctx)
        else:
            _, s, b = self.norm(x, ctx)
            h = (self.gather(x, ctx, scale=s, shift=b) if self.sparse_ok
                 else affine(x, s, b))
        q, k, v = self.q(h, ctx), self.k(h, ctx), self.v(h, ctx)
        if self.sparse_ok:
            k = self.k_scatter(k, ctx)  # full map (cached in full mode)
            v = self.v_scatter(v, ctx)
        # tile layout: [B*K, bs, bs, C]; window / full: [B, H, W, C]
        qt = q.reshape(B, -1, C)
        kt, vt = k.reshape(B, -1, C), v.reshape(B, -1, C)
        out = mha(qt, kt, vt, 1, C)
        add_macs(ctx, 2 * B * qt.shape[1] * kt.shape[1] * C)
        out = self.proj_out(out.reshape(q.shape), ctx)
        if self.sparse_ok:
            return self.out_scatter(out, ctx, residual=x)
        return out + x

    def _chain_window(self, x, ctx: SIGECtx) -> WindowState:
        """Window-resident sparse path with masked stale-K/V attention (see
        ``models/sd/unet.py``): Q/K/V project only the carried canonical
        window; the global K/V are the k/v scatters' cached full maps plus
        the fresh window, with -1e9 biases keeping exactly one token per
        position. No full map is read or written."""
        C = self.channels
        cache = self.out_scatter.cache["original"]
        res = tuple(cache.shape[1:3])
        org, cov = self.gather.read_wsc(res)
        WH, WW = cov.shape
        xw = x.win if isinstance(x, WindowState) else window_slice(
            x, org, (WH, WW))
        B = xw.shape[0]
        _, s, b = self.norm(None, ctx)
        h = affine(xw, s, b)
        q = self.q(h, ctx).reshape(B, WH * WW, C)
        kf = self.k(h, ctx).reshape(B, WH * WW, C)
        vf = self.v(h, ctx).reshape(B, WH * WW, C)
        ks = self.k_scatter.cache["original"].reshape(B, -1, C)
        vs = self.v_scatter.cache["original"].reshape(B, -1, C)

        bias_s, bias_f = stale_fresh_biases(cov, org, res)
        out = masked_mha(q, ks, vs, kf, vf, bias_s, bias_f, 1, C)
        add_macs(ctx, 2 * B * q.shape[1] * (ks.shape[1] + q.shape[1]) * C)
        out = self.proj_out(out.reshape(B, WH, WW, C), ctx)
        y0w = window_slice(cache, org, (WH, WW))
        return WindowState(torch.where(cov[None, :, :, None], out + xw, y0w),
                           cache, org)


class SIGEVAEDownsample(SIGEDownsample):
    """Asymmetric (0,1,0,1) pad stride-2 conv (reference:
    sige_model.py:140-157)."""

    def __init__(self, cfg: SDVAEConfig, channels: int,
                 support_sparse: bool = True):
        super().__init__(channels,
                         cfg.main_block_size if support_sparse else None)


class SIGEVAEUpsample(SIGEUpsample):
    """Nearest 2x + conv (reference: sige_model.py:159-172)."""

    def __init__(self, cfg: SDVAEConfig, channels: int,
                 support_sparse: bool = True):
        super().__init__(channels,
                         cfg.main_block_size if support_sparse else None)


class SIGEEncoder(SIGEModule):
    """Reference: sige_model.py:175-276. ``forward(x, ctx)``: image
    [B, R, W, in_channels] -> moments [B, R/f, W/f, 2 * z_channels]."""

    def __init__(self, cfg: SDVAEConfig = SDVAEConfig()):
        super().__init__()
        self.cfg = cfg
        nres = len(cfg.ch_mult)
        self._head_sparse = cfg.sige_tail and cfg.main_block_size is not None
        self.conv_in = SIGEConv2d(cfg.in_channels, cfg.ch, kernel_size=3,
                                  padding=1, tile_input=self._head_sparse)
        if self._head_sparse:
            # param-free SIGE pair for the stem (the reference runs conv_in
            # dense at full resolution, sige_model.py:232)
            self.in_gather = Gather(block_size=cfg.main_block_size,
                                    kernel_size=3, conv_stride=1,
                                    conv_padding=1)
            self.in_scatter = Scatter(self.in_gather)
        in_mult = (1,) + tuple(cfg.ch_mult)
        blocks, attns, downs = [], [], []
        curr_res = cfg.resolution
        block_in = cfg.ch
        for i in range(nres):
            lvl_blocks, lvl_attns = [], []
            block_in = cfg.ch * in_mult[i]
            block_out = cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks):
                lvl_blocks.append(SIGEVAEResnetBlock(cfg, block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    lvl_attns.append(SIGEVAEAttnBlock(cfg, block_in))
            blocks.append(nn.ModuleList(lvl_blocks))
            attns.append(nn.ModuleList(lvl_attns))
            if i != nres - 1:
                downs.append(SIGEVAEDownsample(cfg, block_in))
                curr_res //= 2
        self.down_blocks = nn.ModuleList(blocks)
        self.down_attns = nn.ModuleList(attns)
        self.downsamples = nn.ModuleList(downs)
        self.mid_block1 = SIGEVAEResnetBlock(cfg, block_in, block_in)
        self.mid_attn = SIGEVAEAttnBlock(cfg, block_in)
        self.mid_block2 = SIGEVAEResnetBlock(cfg, block_in, block_in)
        self.norm_out_scale = nn.Parameter(torch.ones(block_in))
        self.norm_out_bias = nn.Parameter(torch.zeros(block_in))
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = SIGEConv2d(block_in, zc, kernel_size=3, padding=1,
                                   tile_input=False)

    def forward(self, x, ctx: SIGECtx):
        cfg = self.cfg
        if self._head_sparse and ctx.mode == "sparse":
            hwin = self.conv_in(self.in_gather(x, ctx), ctx)
            if (cfg.window_chain and not ctx.sparse_update
                    and self.in_gather.planned_window()):
                # start the window chain at the stem
                cache = self.in_scatter.cache["original"]
                org, cov = self.in_gather.read_wsc(cache.shape[1:3])
                y0w = window_slice(cache, org, cov.shape)
                h = WindowState(torch.where(cov[None, :, :, None], hwin, y0w),
                                cache, org)
            else:
                h = self.in_scatter(hwin, ctx)
        elif self._head_sparse and ctx.mode == "full":
            self.in_gather(x, ctx)  # records meta
            h = self.in_scatter(self.conv_in(x, ctx), ctx)
        else:
            h = self.conv_in(x, ctx)
        for i in range(len(cfg.ch_mult)):
            for ib in range(cfg.num_res_blocks):
                h = self.down_blocks[i][ib](h, ctx)
                if len(self.down_attns[i]):
                    h = self.down_attns[i][ib](h, ctx)
            if i != len(cfg.ch_mult) - 1:
                h = self.downsamples[i](h, ctx)
        h = self.mid_block1(h, ctx)
        h = self.mid_attn(h, ctx)
        h = self.mid_block2(h, ctx)
        h, _, _ = group_norm_with_affine(
            to_map(h), cfg.num_groups, self.norm_out_scale,
            self.norm_out_bias, eps=1e-6)
        return self.conv_out(swish(h), ctx)


class SIGEDecoder(SIGEModule):
    """Reference: sige_model.py:279-392. ``forward(z, ctx)``: latent
    [B, h, w, z_channels] -> image [B, h*f, w*f, out_ch]."""

    def __init__(self, cfg: SDVAEConfig = SDVAEConfig()):
        super().__init__()
        self.cfg = cfg
        nres = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = SIGEConv2d(cfg.z_channels, block_in, kernel_size=3,
                                  padding=1, tile_input=False)
        self.mid_block1 = SIGEVAEResnetBlock(cfg, block_in, block_in)
        self.mid_attn = SIGEVAEAttnBlock(cfg, block_in)
        self.mid_block2 = SIGEVAEResnetBlock(cfg, block_in, block_in)
        curr_res = cfg.resolution // (2 ** (nres - 1))
        blocks, attns, ups = [], [], []
        for i in reversed(range(nres)):
            lvl_blocks, lvl_attns = [], []
            block_out = cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks + 1):
                lvl_blocks.append(SIGEVAEResnetBlock(cfg, block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    lvl_attns.append(SIGEVAEAttnBlock(cfg, block_in))
            blocks.insert(0, nn.ModuleList(lvl_blocks))
            attns.insert(0, nn.ModuleList(lvl_attns))
            if i != 0:
                ups.insert(0, SIGEVAEUpsample(cfg, block_in))
                curr_res *= 2
        self.up_blocks = nn.ModuleList(blocks)
        self.up_attns = nn.ModuleList(attns)
        self.upsamples = nn.ModuleList(ups)
        self.norm_out_scale = nn.Parameter(torch.ones(block_in))
        self.norm_out_bias = nn.Parameter(torch.zeros(block_in))
        self._tail_sparse = cfg.sige_tail and cfg.main_block_size is not None
        self.conv_out = SIGEConv2d(block_in, cfg.out_ch, kernel_size=3,
                                   padding=1, tile_input=self._tail_sparse)
        if self._tail_sparse:
            # param-free SIGE pair for the tail: norm_out's affine is folded
            # from the full pass into the gather epilogue (the reference
            # keeps this tail dense; its DDPM models fold every norm so)
            self.norm_out_fold = FoldedNormAffine(cfg.num_groups)
            self.out_gather = Gather(block_size=cfg.main_block_size,
                                     kernel_size=3, conv_stride=1,
                                     conv_padding=1, activation="swish")
            self.out_scatter = Scatter(self.out_gather)

    def _tail(self, h, ctx: SIGECtx):
        """norm_out -> swish -> conv_out. Dense mode is the reference's
        live-statistics tail; full mode also caches the folded affine and
        the output map; sparse replays them windowed or tiled."""
        cfg = self.cfg
        if not self._tail_sparse or ctx.mode == "dense":
            h, _, _ = group_norm_with_affine(
                to_map(h), cfg.num_groups, self.norm_out_scale,
                self.norm_out_bias, eps=1e-6)
            return self.conv_out(swish(h), ctx)
        if ctx.mode == "full":
            h = to_map(h)
            hn, _, _ = self.norm_out_fold(
                h, self.norm_out_scale, self.norm_out_bias, ctx)
            self.out_gather(h, ctx)  # records meta
            return self.out_scatter(self.conv_out(swish(hn), ctx), ctx)
        _, sc, sh = self.norm_out_fold(
            None, self.norm_out_scale, self.norm_out_bias, ctx)
        if isinstance(h, WindowState) and self.out_gather.planned_window():
            meta, edge = self.out_gather.read_window()
            ext = window_chain_extend(h.win, h.org, h.cache, meta, edge, sc,
                                      sh, "swish",
                                      rel=chain_rel(self.out_gather))
        else:
            ext = self.out_gather(to_map(h), ctx, scale=sc, shift=sh)
        return self.out_scatter(self.conv_out(ext, ctx), ctx)

    def forward(self, z, ctx: SIGECtx):
        cfg = self.cfg
        h = self.conv_in(z, ctx)
        h = self.mid_block1(h, ctx)
        h = self.mid_attn(h, ctx)
        h = self.mid_block2(h, ctx)
        for i in reversed(range(len(cfg.ch_mult))):
            for ib in range(cfg.num_res_blocks + 1):
                h = self.up_blocks[i][ib](h, ctx)
                if len(self.up_attns[i]):
                    h = self.up_attns[i][ib](h, ctx)
            if i != 0:
                # the upsample takes a WindowState directly (chains cross
                # the resample; it materializes otherwise)
                h = self.upsamples[i - 1](h, ctx)
        return self._tail(h, ctx)
