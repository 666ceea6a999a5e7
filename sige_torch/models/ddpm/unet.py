"""DDPM U-Net (Ho et al. architecture) with SIGE sparse wiring — the port
of ``sige_tpu.models.ddpm.unet``.

One module serves three execution modes through :class:`SIGECtx`:
``dense`` (the vanilla baseline), ``full`` (dense + cache/affine
refresh), and ``sparse`` (tile inference). The SIGE wiring mirrors the
reference's ``SIGEFusedUNet``
(reference: diffusion/models/ddpm_arch/sige_fused_unet.py):

  * resblocks: gather(+folded norm1, swish) -> conv1 -> fused
    scatter/re-gather(+folded norm2 with temb absorbed into the shift,
    swish) -> conv2 -> scatter(+shortcut); shortcut uses its own
    block-size-4 gather and the block-residual join when channels change;
  * attention stays *global*: qkv tiles are scattered back onto the cached
    full map before attention, and only proj_out runs on tiles;
  * levels are sparse only at resolution >= ``sparse_resolution_threshold``
    (64 for church256 — so attention at 16 runs dense with cached folded
    norms);
  * the per-block temb projections are fused into one linear layer
    (reference: fused_unet.py:244-295), sliced per block in traversal
    order;
  * Downsample pads (0,1,0,1) asymmetrically in full/dense mode only; the
    sparse path relies on gather offset 0
    (reference: sige_fused_unet.py:243-246);
  * in the window layout with ``window_chain``, resblocks, skip joins,
    resamples, the stem and the tail thread (window, cache) state
    (:class:`~sige_torch.nn.module.WindowState`) and full maps
    materialize only at chain breaks (attention, the non-chain paths).

Activations are NHWC; module names follow ``sige_tpu``'s flax names
(``down_blocks_0_1`` there is ``down_blocks.0.1`` here), so the weight
bridge and the plan trees map one to one.

As in ``sige_tpu``, the attention block's folded norm keeps the full
per-channel affine (the reference indexes it by cache id).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...nn.module import (Gather, Scatter, SIGECtx, SIGEConv2d, SIGEModule,
                          add_dense_macs, add_macs)
from ...ops.attention import mha
from ..blocks import (FoldedGroupNorm, ResBlock, SIGEDownsample,
                      SIGEUNetEnds, SIGEUpsample, affine, swish, to_map)


@dataclasses.dataclass(frozen=True)
class DDPMUNetConfig:
    """Architecture config (church256 defaults; reference:
    diffusion/configs/church_ddpm256-sige.yml). The fields and defaults
    are ``sige_tpu``'s."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_ch: int = 3
    out_ch: int = 3
    resolution: int = 256
    resamp_with_conv: bool = True
    num_groups: int = 32
    block_size_normal: Optional[int] = 6
    block_size_instance: Optional[int] = 4
    sparse_resolution_threshold: int = 64
    #: window-layout chains: thread (window, cache) state through
    #: resblocks, skip concatenations and upsamples (full maps only at
    #: attention, downsamples without a chain marker and non-chain paths)
    window_chain: bool = True
    #: SIGE-ify the tail (fold norm_out's affine from the full pass,
    #: gather/scatter the conv_out); sparse == full on the original input
    #: is preserved exactly.
    sige_tail: bool = True
    #: cache slots per cache (the demo's one per denoising step); the
    #: engine holds them and binds a call's slot to every layer
    cache_slots: int = 1

    @property
    def temb_ch(self) -> int:
        return self.ch * 4


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (transformer/fairseq convention;
    reference: diffusion/models/common.py:8-26)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = nn.functional.pad(emb, (0, 1))
    return emb


class SIGEResnetBlock(ResBlock):
    """Reference: diffusion/models/ddpm_arch/sige_fused_unet.py:10-131."""

    def __init__(self, cfg: DDPMUNetConfig, in_channels: int,
                 out_channels: int, support_sparse: bool = False):
        super().__init__(in_channels, out_channels, cfg.num_groups,
                         cfg.block_size_normal if support_sparse else None,
                         cfg.block_size_instance, cfg.window_chain)

    def forward(self, x, temb, ctx: SIGECtx):
        """``temb``: [B, out_channels] slice of the fused projection (full /
        dense modes; None in sparse — it lives in the cached shift)."""
        return self._run(x, ctx, lambda: temb)


class SIGEAttnBlock(SIGEModule):
    """Global attention, single-head (DDPM) or with ``heads`` heads of
    ``head_dim`` (PD: sige_unet.py:177-266); in sparse mode the qkv tiles
    are scattered onto the cached full qkv map so K/V stay global
    (reference: diffusion/models/ddpm_arch/sige_fused_unet.py:134-209).
    The qkv conv's output splits into q | k | v, each heads x head_dim
    with the heads outermost. The attention itself is
    :func:`sige_torch.ops.attention.mha`, which on the GPU is the
    hand-written flash kernel."""

    def __init__(self, cfg, channels: int, support_sparse: bool = False,
                 heads: int = 1, head_dim: Optional[int] = None):
        super().__init__()
        self.channels = channels
        self.heads = heads
        self.head_dim = head_dim or channels // heads
        inner = heads * self.head_dim
        self.sparse_ok = support_sparse and cfg.block_size_instance is not None
        self.norm = FoldedGroupNorm(channels, cfg.num_groups)
        self.qkv = SIGEConv2d(channels, 3 * inner, kernel_size=1,
                              padding=0, tile_input=self.sparse_ok)
        self.proj_out = SIGEConv2d(inner, channels, kernel_size=1,
                                   padding=0, tile_input=self.sparse_ok)
        if self.sparse_ok:
            bs = cfg.block_size_instance
            self.gather1 = Gather(block_size=bs, kernel_size=1,
                                  conv_stride=1, conv_padding=0)
            self.scatter1 = Scatter(self.gather1)
            self.gather2 = Gather(block_size=bs, kernel_size=1,
                                  conv_stride=1, conv_padding=0)
            self.scatter2 = Scatter(self.gather2)

    def _attend(self, qkv, ctx: SIGECtx):
        B, H, W, _ = qkv.shape
        inner = self.heads * self.head_dim
        q, k, v = qkv.reshape(B, H * W, 3 * inner).split(inner, dim=-1)
        out = mha(q, k, v, self.heads, self.head_dim)
        add_macs(ctx, 2 * B * H * W * H * W * inner)
        return out.reshape(B, H, W, inner)

    def forward(self, x, ctx: SIGECtx):
        x = to_map(x)  # global attention needs the full map (chain break)
        if ctx.mode in ("dense", "full"):
            h = x
            if self.sparse_ok:
                h = self.gather1(h, ctx)
            h, _, _ = self.norm(h, ctx)
        else:
            _, s, b = self.norm(x, ctx)
            if self.sparse_ok:
                h = self.gather1(x, ctx, scale=s, shift=b)
            else:
                h = affine(x, s, b)
        qkv = self.qkv(h, ctx)
        if self.sparse_ok:
            qkv = self.scatter1(qkv, ctx)  # full map: fresh tiles + cache
        h = self._attend(qkv, ctx)
        if self.sparse_ok:
            h = self.gather2(h, ctx)
        h = self.proj_out(h, ctx)
        if self.sparse_ok:
            return self.scatter2(h, ctx, residual=x)
        return h + x


class SIGEFusedUNet(SIGEUNetEnds):
    """The full U-Net. ``forward(x, t, ctx)`` with x [B, H, W, in_ch] and
    t [B] timesteps. Its layers follow ``cfg.cache_slots`` (the engine
    binds the slot) and ``sparse_update`` (the window chains step aside:
    a chain never forms the scattered maps the caches take)."""

    def __init__(self, cfg: DDPMUNetConfig = DDPMUNetConfig()):
        super().__init__()
        self.cfg = cfg
        nres = len(cfg.ch_mult)
        self.temb_dense0 = nn.Linear(cfg.ch, cfg.temb_ch)
        self.temb_dense1 = nn.Linear(cfg.temb_ch, cfg.temb_ch)
        self._init_stem(cfg)

        in_mult = (1,) + tuple(cfg.ch_mult)
        down_blocks, down_attns, downsamples = [], [], []
        temb_slices = []  # (start, size) per resblock in traversal order
        temb_dim = 0
        curr_res = cfg.resolution
        block_in = None
        for i in range(nres):
            blocks, attns = [], []
            block_in = cfg.ch * in_mult[i]
            block_out = cfg.ch * cfg.ch_mult[i]
            sparse = curr_res >= cfg.sparse_resolution_threshold
            for _ in range(cfg.num_res_blocks):
                blocks.append(SIGEResnetBlock(cfg, block_in, block_out,
                                              support_sparse=sparse))
                temb_slices.append((temb_dim, block_out))
                temb_dim += block_out
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(SIGEAttnBlock(cfg, block_in,
                                               support_sparse=sparse))
            down_blocks.append(nn.ModuleList(blocks))
            down_attns.append(nn.ModuleList(attns))
            if i != nres - 1:
                downsamples.append(SIGEDownsample(
                    block_in, cfg.block_size_normal if sparse else None))
                curr_res //= 2
        self.down_blocks = nn.ModuleList(down_blocks)
        self.down_attns = nn.ModuleList(down_attns)
        self.downsamples = nn.ModuleList(downsamples)

        self.mid_block1 = SIGEResnetBlock(cfg, block_in, block_in)
        temb_slices.append((temb_dim, block_in))
        temb_dim += block_in
        self.mid_attn = SIGEAttnBlock(cfg, block_in)
        self.mid_block2 = SIGEResnetBlock(cfg, block_in, block_in)
        temb_slices.append((temb_dim, block_in))
        temb_dim += block_in

        up_blocks, up_attns, upsamples = [], [], []
        for i in reversed(range(nres)):
            blocks, attns = [], []
            block_out = cfg.ch * cfg.ch_mult[i]
            skip_in = cfg.ch * cfg.ch_mult[i]
            sparse = curr_res >= cfg.sparse_resolution_threshold
            for ib in range(cfg.num_res_blocks + 1):
                if ib == cfg.num_res_blocks:
                    skip_in = cfg.ch * in_mult[i]
                blocks.append(SIGEResnetBlock(cfg, block_in + skip_in,
                                              block_out,
                                              support_sparse=sparse))
                temb_slices.append((temb_dim, block_out))
                temb_dim += block_out
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(SIGEAttnBlock(cfg, block_in,
                                               support_sparse=sparse))
            up_blocks.insert(0, nn.ModuleList(blocks))
            up_attns.insert(0, nn.ModuleList(attns))
            if i != 0:
                upsamples.insert(0, SIGEUpsample(block_in,
                                                 cfg.block_size_normal))
                curr_res *= 2
        self.up_blocks = nn.ModuleList(up_blocks)
        self.up_attns = nn.ModuleList(up_attns)
        self.upsamples = nn.ModuleList(upsamples)
        self._temb_slices = temb_slices
        self.temb_proj_dim = temb_dim
        # Fused per-block temb projection (reference: fused_unet.py:244-260).
        self.temb_proj = nn.Linear(cfg.temb_ch, temb_dim)
        self._init_tail(cfg, block_in)

    def _temb(self, t, ctx: SIGECtx):
        cfg = self.cfg
        temb = timestep_embedding(t, cfg.ch)
        add_dense_macs(ctx, temb, cfg.temb_ch)
        temb = swish(self.temb_dense0(temb))
        add_dense_macs(ctx, temb, cfg.temb_ch)
        temb = swish(self.temb_dense1(temb))
        add_dense_macs(ctx, temb, self.temb_proj_dim)
        return self.temb_proj(temb)

    def forward(self, x, t, ctx: SIGECtx):
        cfg = self.cfg
        nres = len(cfg.ch_mult)
        temb = self._temb(t, ctx) if ctx.mode in ("dense", "full") else None
        slices = iter(self._temb_slices)

        def tslice():
            start, size = next(slices)
            return None if temb is None else temb[:, start:start + size]

        hs = [self._stem(x, ctx)]
        for i in range(nres):
            for ib in range(cfg.num_res_blocks):
                h = self.down_blocks[i][ib](hs[-1], tslice(), ctx)
                if len(self.down_attns[i]):
                    h = self.down_attns[i][ib](h, ctx)
                hs.append(h)
            if i != nres - 1:
                hs.append(self.downsamples[i](hs[-1], ctx))

        h = hs[-1]
        h = self.mid_block1(h, tslice(), ctx)
        h = self.mid_attn(h, ctx)
        h = self.mid_block2(h, tslice(), ctx)

        for i in reversed(range(nres)):
            for ib in range(cfg.num_res_blocks + 1):
                h = self.up_blocks[i][ib]((h, hs.pop()), tslice(), ctx)
                if len(self.up_attns[i]):
                    h = self.up_attns[i][ib](h, ctx)
            if i != 0:
                h = self.upsamples[i - 1](h, ctx)
        return self._tail(h, ctx)
