"""Blocks the port's U-Nets and VAE share: the folded GroupNorms, the
SIGE resblock (with an optional in-block resample and scale-shift time
embedding), the stride-2 downsample and the nearest-2x upsample, with
their tile and window-chain paths, the U-Net stem and tail, and small
NHWC helpers.

The DDPM U-Net (``models/ddpm/unet.py``), the PD U-Net
(``models/pd/unet.py``), the SD U-Net and the SD VAE (``models/sd/``)
build on these; in ``sige_tpu`` each model module holds its own copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..nn.module import (Gather, Scatter, ScatterGather,
                         ScatterWithBlockResidual, SIGECtx, SIGEConv2d,
                         SIGEModule, WindowState, chain_rel)
from ..nn.norm import group_norm_with_affine
from ..ops.window import (window_chain_extend, window_chain_extend_up2,
                          window_epilogue, window_gather, window_slice)

RESAMPLES = (None, "down", "up")


def to_map(x):
    """Materialize a chain state at a chain break."""
    return x.to_map() if isinstance(x, WindowState) else x


def up2(x):
    """Nearest 2x upsample of NHWC ``x`` in one copy."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)


def avg_pool2(x):
    """2x2 average pool of NHWC ``x``."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def swish(x):
    return x * torch.sigmoid(x)


def affine(x, scale, shift):
    """``x * scale + shift`` with [B, C] params over NHWC x."""
    return x * scale[:, None, None, :] + shift[:, None, None, :]


class FoldedGroupNorm(SIGEModule):
    """GroupNorm whose (scale, shift) affine is cached per slot in full
    mode and replayed in sparse mode."""

    def __init__(self, channels: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, ctx: SIGECtx, pre_shift=None, post_scale=None,
                post_shift=None):
        """In dense/full mode: normalize x (returned *without* the post
        terms) and, in full mode, cache the composed affine:

          * ``pre_shift`` — a [B, C] offset already added to the *input*
            (DDPM's additive temb): shift += pre_shift * scale
            (reference: sige_fused_unet.py:87-89);
          * ``post_scale`` / ``post_shift`` — [B, C] terms the caller
            applies *after* the norm (PD's ``h * (1 + s) + b``): scale and
            shift are scaled by post_scale, then shift += post_shift
            (reference: pd_arch/sige_unet.py:113-120).

        In sparse mode: return the cached (scale, shift) for the gather
        epilogues instead of touching x."""
        if ctx.mode in ("dense", "full"):
            xn, scale, shift = group_norm_with_affine(
                x, self.num_groups, self.weight, self.bias, eps=1e-6)
            if ctx.mode == "full":
                if pre_shift is not None:
                    shift = pre_shift * scale + shift
                if post_scale is not None:
                    scale = post_scale * scale
                    shift = post_scale * shift
                if post_shift is not None:
                    shift = shift + post_shift
                self.cache["scale"], self.cache["shift"] = scale, shift
            return xn, None, None
        if ctx.mode == "sparse":
            return None, self.cache["scale"], self.cache["shift"]
        raise ValueError(ctx.mode)


class FoldedNormAffine(SIGEModule):
    """GroupNorm using externally-owned (w, b) params whose equivalent
    per-channel affine is cached per slot in full mode and replayed in
    sparse mode (the model-tail variant of FoldedGroupNorm)."""

    def __init__(self, num_groups: int):
        super().__init__()
        self.num_groups = num_groups

    def forward(self, x, w, b, ctx: SIGECtx):
        if ctx.mode in ("dense", "full"):
            xn, sc, sh = group_norm_with_affine(x, self.num_groups, w, b,
                                                eps=1e-6)
            if ctx.mode == "full":
                self.cache["scale"], self.cache["shift"] = sc, sh
            return xn, None, None
        return None, self.cache["scale"], self.cache["shift"]


class ResBlock(SIGEModule):
    """The SIGE resblock the DDPM, PD, SD and VAE models share:
    gather(+norm1, swish) -> conv1 -> fused scatter/re-gather(+norm2 with
    the time embedding folded into its affine, swish) -> conv2 ->
    scatter(+shortcut); a block-size ``shortcut_block_size`` gather and
    the block-residual join when the channels change. ``main_block_size``
    None runs the block dense (over cached affines in sparse mode).
    ``shortcut_name`` is the shortcut conv's parameter name (``skip`` in
    the SD U-Net).

    ``resample`` ("down": 2x2 avg-pool, "up": nearest 2x; PD's blocks)
    resamples inside the block, after norm1's swish on the main path and
    on the shortcut; the main gather then runs at the resampled
    resolution with an identity epilogue (the norm1 swish cannot fuse
    across the resample; reference: pd_arch/sige_unet.py:144-152)."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int,
                 main_block_size: Optional[int],
                 shortcut_block_size: Optional[int], window_chain: bool,
                 shortcut_name: str = "nin_shortcut",
                 resample: Optional[str] = None):
        super().__init__()
        if resample not in RESAMPLES:
            raise ValueError(f"resample {resample!r} not in {RESAMPLES}")
        cin, cout = in_channels, out_channels
        self.in_channels, self.out_channels = cin, cout
        self.window_chain = window_chain
        self.resample = resample
        self.main_sparse = main_block_size is not None
        self.shortcut_sparse = (self.main_sparse and cin != cout
                                and shortcut_block_size is not None)
        self.norm1 = FoldedGroupNorm(cin, num_groups)
        self.conv1 = SIGEConv2d(cin, cout, kernel_size=3, padding=1,
                                tile_input=self.main_sparse)
        self.norm2 = FoldedGroupNorm(cout, num_groups)
        self.conv2 = SIGEConv2d(cout, cout, kernel_size=3, padding=1,
                                tile_input=self.main_sparse)
        if self.main_sparse:
            self.main_gather = Gather(
                block_size=main_block_size, kernel_size=3,
                conv_stride=1, conv_padding=1,
                activation="swish" if resample is None else "identity",
                prepool_chain=resample == "down")
            self.sg = ScatterGather(self.main_gather, activation="swish")
        self._shortcut_name = shortcut_name
        if cin != cout:
            setattr(self, shortcut_name, SIGEConv2d(
                cin, cout, kernel_size=1, padding=0,
                tile_input=self.shortcut_sparse))
            if self.shortcut_sparse:
                self.shortcut_gather = Gather(
                    block_size=shortcut_block_size, kernel_size=1,
                    conv_stride=1, conv_padding=0)
                self.join = ScatterWithBlockResidual(
                    self.main_gather, self.shortcut_gather)
            elif self.main_sparse:
                self.join = Scatter(self.main_gather)
        elif self.main_sparse:
            self.join = Scatter(self.main_gather)

    def _shortcut(self, xs, ctx: SIGECtx):
        return getattr(self, self._shortcut_name)(xs, ctx)

    def _resample(self, x):
        if self.resample == "down":
            return avg_pool2(x)
        if self.resample == "up":
            return up2(x)
        return x

    def _chains_across_resample(self, x) -> bool:
        """Whether the window chain crosses this block's resample: an
        upsample needs a carried window and the planner's up2 marker, a
        downsample the pre-pool products."""
        plan = self.main_gather.plan_host
        if self.resample == "up":
            return isinstance(x, WindowState) and "wup_ok" in plan
        if self.resample == "down":
            return "wdnp_in" in plan
        return True

    def _run(self, x, ctx: SIGECtx, temb=None, live: bool = False):
        """``temb``: a callable called in dense/full mode only (in sparse
        mode the time embedding lives in the cached norm2 affine), giving
        either a [B, out_channels] offset added before norm2, or a pair
        (post_scale, post_shift) applied after it as ``h * post_scale +
        post_shift`` (PD's scale-shift); None for blocks without one.
        ``live``: run dense with live statistics in sparse mode (the SD
        middle block). ``x`` may be a tuple (h, skip): the U-Net's skip
        concatenation. Dense/full/tile modes concatenate the maps here;
        the window-chain sparse path extends each part's window and
        concatenates windows."""
        if (ctx.mode == "sparse" and not live and self.main_sparse
                and self.window_chain and not ctx.sparse_update
                and self.main_gather.planned_window()
                and self._chains_across_resample(x)):
            return self._chain_window(x, ctx)
        if isinstance(x, tuple):
            x = torch.cat([to_map(a) for a in x], dim=-1)
        else:
            x = to_map(x)
        dctx = dataclasses.replace(ctx, mode="dense") if live else ctx
        h, xs = x, self._resample(x)
        if self.in_channels != self.out_channels:
            if self.shortcut_sparse:
                xs = self.shortcut_gather(xs, dctx)
            xs = self._shortcut(xs, dctx)

        if ctx.mode in ("dense", "full") or live:
            ctx = dctx
            h, _, _ = self.norm1(h, ctx)
            h = self._resample(swish(h))
            if self.main_sparse:
                h = self.main_gather(h, ctx)  # records geometry/resolution
            h = self.conv1(h, ctx)
            if self.main_sparse:
                h = self.sg(h, ctx)  # caches conv1 output (pre-temb)
            t = None if temb is None else temb()
            if isinstance(t, tuple):
                h, _, _ = self.norm2(h, ctx, post_scale=t[0], post_shift=t[1])
                h = affine(h, *t)
            else:
                if t is not None:
                    h = h + t[:, None, None, :]
                h, _, _ = self.norm2(h, ctx, pre_shift=t)
            h = swish(h)
            h = self.conv2(h, ctx)
        else:  # sparse
            _, s1, b1 = self.norm1(h, ctx)
            if self.main_sparse and self.resample is None:
                h = self.main_gather(h, ctx, scale=s1, shift=b1)  # swish fused
            else:
                h = self._resample(swish(affine(h, s1, b1)))
                if self.main_sparse:
                    h = self.main_gather(h, ctx)
            h = self.conv1(h, ctx)
            _, s2, b2 = self.norm2(h, ctx)
            if self.main_sparse:
                h = self.sg(h, ctx, scale=s2, shift=b2)  # swish fused
            else:
                h = swish(affine(h, s2, b2))
            h = self.conv2(h, ctx)

        if self.main_sparse:
            return self.join(h, ctx, residual=xs)
        return h + xs

    # -- window-resident sparse path -------------------------------------
    @staticmethod
    def _extend_part(p, meta, edge, rel=None):
        if isinstance(p, WindowState):
            return window_chain_extend(p.win, p.org, p.cache, meta, edge,
                                       rel=rel)
        return window_gather(p, meta, edge)

    @staticmethod
    def _part_window(p, org, shape):
        if isinstance(p, WindowState):
            return p.win
        return window_slice(p, org, shape)

    def _chain_window(self, x, ctx: SIGECtx) -> WindowState:
        g = self.main_gather
        meta, edge = g.read_window()
        org = g.window_origin()
        parts = x if isinstance(x, tuple) else (x,)

        _, s1, b1 = self.norm1(None, ctx)
        if self.resample == "up":
            # norm1 and swish come before the nearest-2x resample; both
            # are pointwise, so they run on the carried window, which is
            # then doubled: the planner's nesting makes it cover the
            # extraction window (no cache read)
            st = parts[0]
            org2 = (2 * st.org[0], 2 * st.org[1])
            ext = window_chain_extend_up2(up2(swish(affine(st.win, s1, b1))),
                                          org2, meta, edge)
        elif self.resample == "down":
            # norm1 and swish come before the avg-pool: the extraction
            # window doubled to the producer's resolution, from its
            # (window, cache) state, then the epilogue and the pool; the
            # full fine map is never touched. The raw doubled window also
            # gives the pooled shortcut below.
            meta2, edge2 = g.read_prepool()
            ext2 = self._extend_part(parts[0], meta2, edge2)
            ext = avg_pool2(window_epilogue(
                ext2, None if len(meta2) == 2 else edge2, s1, b1, "swish"))
        else:
            rel = chain_rel(g)
            ext = [self._extend_part(p, meta, edge, rel) for p in parts]
            ext = ext[0] if len(ext) == 1 else torch.cat(ext, dim=-1)
            ext = window_epilogue(ext, None if len(meta) == 2 else edge, s1,
                                  b1, "swish")
        h = self.conv1(ext, ctx)
        _, s2, b2 = self.norm2(h, ctx)  # cached affine includes temb shift
        h = self.sg(h, ctx, scale=s2, shift=b2)
        h = self.conv2(h, ctx)

        cache = self.join.cache["original"]
        res = cache.shape[1:3]
        _, cov = g.read_wsc(res)
        WH, WW = cov.shape
        if self.resample == "up":
            # the shortcut is the nearest-2x of the input: the doubled
            # carried window at the output window's origin
            xs = window_slice(up2(st.win),
                              (org[0] - org2[0], org[1] - org2[1]), (WH, WW))
        elif self.resample == "down":
            # the shortcut is the avg-pool of the input: the doubled window
            # starts at 2 * (org - 1), so the output window's pre-pool
            # extent starts at (2, 2)
            xs = avg_pool2(ext2[:, 2:2 + 2 * WH, 2:2 + 2 * WW])
        else:
            xs = [self._part_window(p, org, (WH, WW)) for p in parts]
            xs = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        y0w = window_slice(cache, org, (WH, WW))
        m = cov[None, :, :, None]
        if self.in_channels != self.out_channels:
            xs = self._shortcut(xs, ctx)
            if self.shortcut_sparse:
                # the two-mask block-residual join (as
                # window_scatter_block_residual and the tile engine):
                # out = where(m, main + y1, y0) + where(s, short - y1, 0)
                _, cov_s = self.shortcut_gather.read_wsc(res)
                y1w = window_slice(self.join.cache["residual"], org, (WH, WW))
                s = cov_s[None, :, :, None]
                zero = torch.zeros((), dtype=h.dtype, device=h.device)
                out = (torch.where(m, h + y1w, y0w)
                       + torch.where(s, xs - y1w, zero))
                return WindowState(out, cache, org)
        return WindowState(torch.where(m, h + xs, y0w), cache, org)


class SIGEDownsample(SIGEModule):
    """Stride-2 conv with (0,1,0,1) asymmetric padding in dense/full mode;
    sparse tiles carry their own halo (gather padding 0)
    (reference: sige_fused_unet.py:229-248). ``padding`` 1 is the SD
    U-Net's symmetric form (its gather pads 1 too); ``block_size`` None
    runs it dense. The conv's parameter name is ``conv_name``."""

    conv_name = "conv"

    def __init__(self, channels: int, block_size: Optional[int] = None,
                 padding=((0, 1), (0, 1))):
        super().__init__()
        self.sparse_ok = block_size is not None
        setattr(self, self.conv_name, SIGEConv2d(
            channels, channels, kernel_size=3, stride=2, padding=padding,
            tile_input=self.sparse_ok))
        if self.sparse_ok:
            self.g = Gather(block_size=block_size, kernel_size=3,
                            conv_stride=2,
                            conv_padding=padding if isinstance(padding, int)
                            else 0)
            self.s = Scatter(self.g)

    def forward(self, x, ctx: SIGECtx):
        conv = getattr(self, self.conv_name)
        if (self.sparse_ok and ctx.mode == "sparse" and not ctx.sparse_update
                and self.g.planned_window() and "wdn_ok" in self.g.plan_host):
            # window-resident across the downsample: the stride-2
            # extraction window spans ~2x the coarse canonical window,
            # which the planner's nesting makes cover the carried fine
            # window
            meta, edge = self.g.read_window()
            if isinstance(x, WindowState):
                ext = window_chain_extend(x.win, x.org, x.cache, meta, edge)
            else:
                ext = window_gather(x, meta, edge)
            h = conv(ext, ctx)
            cache = self.s.cache["original"]
            org, cov = self.g.read_wsc(cache.shape[1:3])
            y0w = window_slice(cache, org, cov.shape)
            return WindowState(torch.where(cov[None, :, :, None], h, y0w),
                               cache, org)
        x = to_map(x)
        if self.sparse_ok:
            x = self.g(x, ctx)
        x = conv(x, ctx)
        if self.sparse_ok:
            x = self.s(x, ctx)
        return x


class SIGEUpsample(SIGEModule):
    """Nearest 2x upsample + 3x3 conv (reference: sige_fused_unet.py:212-227);
    ``block_size`` None runs it dense."""

    def __init__(self, channels: int, block_size: Optional[int] = None):
        super().__init__()
        self.sparse_ok = block_size is not None
        self.conv = SIGEConv2d(channels, channels, kernel_size=3, padding=1,
                               tile_input=self.sparse_ok)
        if self.sparse_ok:
            self.g = Gather(block_size=block_size, kernel_size=3,
                            conv_stride=1, conv_padding=1)
            self.s = Scatter(self.g)

    def forward(self, x, ctx: SIGECtx):
        if (isinstance(x, WindowState) and self.sparse_ok
                and not ctx.sparse_update and self.g.planned_window()
                and "wup_ok" in self.g.plan_host):
            # window-resident across the resample: the doubled carried
            # window covers the extraction window
            meta, edge = self.g.read_window()
            ext = window_chain_extend_up2(
                up2(x.win), (2 * x.org[0], 2 * x.org[1]), meta, edge)
            h = self.conv(ext, ctx)
            cache = self.s.cache["original"]
            org = self.g.window_origin()
            _, cov = self.g.read_wsc(cache.shape[1:3])
            y0w = window_slice(cache, org, cov.shape)
            return WindowState(torch.where(cov[None, :, :, None], h, y0w),
                               cache, org)
        x = up2(to_map(x))
        if self.sparse_ok:
            x = self.g(x, ctx)
        x = self.conv(x, ctx)
        if self.sparse_ok:
            x = self.s(x, ctx)
        return x


class SIGEUNetEnds(SIGEModule):
    """The stem and the tail the DDPM and PD U-Nets share: a 3x3 stem conv
    with a param-free SIGE pair (the window chain starts there), and the
    tail GroupNorm + swish + 3x3 conv with norm_out's affine folded from
    the full pass into the gather epilogue (``sige_tail``). The
    parameters keep ``sige_tpu``'s names (``conv_in``, ``norm_out_scale``,
    ``norm_out_bias``, ``conv_out``)."""

    def _init_stem(self, cfg) -> None:
        self._head_sparse = (cfg.sige_tail
                             and cfg.block_size_normal is not None
                             and cfg.resolution
                             >= cfg.sparse_resolution_threshold)
        self.conv_in = SIGEConv2d(cfg.in_ch, cfg.ch, kernel_size=3, padding=1,
                                  tile_input=self._head_sparse)
        if self._head_sparse:
            self.in_gather = Gather(block_size=cfg.block_size_normal,
                                    kernel_size=3, conv_stride=1,
                                    conv_padding=1)
            self.in_scatter = Scatter(self.in_gather)

    def _init_tail(self, cfg, channels: int) -> None:
        self.norm_out_scale = nn.Parameter(torch.ones(channels))
        self.norm_out_bias = nn.Parameter(torch.zeros(channels))
        self._tail_sparse = (cfg.sige_tail
                             and cfg.block_size_normal is not None)
        self.conv_out = SIGEConv2d(channels, cfg.out_ch, kernel_size=3,
                                   padding=1, tile_input=self._tail_sparse)
        if self._tail_sparse:
            self.norm_out_fold = FoldedNormAffine(cfg.num_groups)
            self.out_gather = Gather(block_size=cfg.block_size_normal,
                                     kernel_size=3, conv_stride=1,
                                     conv_padding=1, activation="swish")
            self.out_scatter = Scatter(self.out_gather)

    def _stem(self, x, ctx: SIGECtx):
        """The stem's output: a map, or in the window layout with
        ``window_chain`` a :class:`WindowState` (its state also rides the
        last skip)."""
        if self._head_sparse and ctx.mode == "sparse":
            hwin = self.conv_in(self.in_gather(x, ctx), ctx)
            if (self.cfg.window_chain and not ctx.sparse_update
                    and self.in_gather.planned_window()):
                cache = self.in_scatter.cache["original"]
                org, cov = self.in_gather.read_wsc(cache.shape[1:3])
                y0w = window_slice(cache, org, cov.shape)
                return WindowState(torch.where(cov[None, :, :, None], hwin,
                                               y0w), cache, org)
            return self.in_scatter(hwin, ctx)
        if self._head_sparse and ctx.mode == "full":
            self.in_gather(x, ctx)  # records meta
            return self.in_scatter(self.conv_in(x, ctx), ctx)
        return self.conv_in(x, ctx)

    def _tail(self, h, ctx: SIGECtx):
        if self._tail_sparse and ctx.mode == "full":
            h = to_map(h)
            hn, _, _ = self.norm_out_fold(
                h, self.norm_out_scale, self.norm_out_bias, ctx)
            self.out_gather(h, ctx)  # records meta
            out = self.conv_out(swish(hn), ctx)
            return self.out_scatter(out, ctx)
        if self._tail_sparse and ctx.mode == "sparse":
            _, sc, sh = self.norm_out_fold(
                None, self.norm_out_scale, self.norm_out_bias, ctx)
            if isinstance(h, WindowState) and self.out_gather.planned_window():
                meta, edge = self.out_gather.read_window()
                ext = window_chain_extend(h.win, h.org, h.cache, meta, edge,
                                          sc, sh, "swish",
                                          rel=chain_rel(self.out_gather))
            else:
                ext = self.out_gather(to_map(h), ctx, scale=sc, shift=sh)
            out = self.conv_out(ext, ctx)
            return self.out_scatter(out, ctx)
        h, _, _ = group_norm_with_affine(
            to_map(h), self.cfg.num_groups, self.norm_out_scale,
            self.norm_out_bias, eps=1e-6)
        return self.conv_out(swish(h), ctx)
