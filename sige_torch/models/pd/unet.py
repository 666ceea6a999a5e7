"""Progressive Distillation U-Net with SIGE sparse wiring — the port of
``sige_tpu.models.pd.unet``.

Architectural differences from the DDPM U-Net (reference:
diffusion/models/pd_arch/{unet,sige_unet}.py):
  * resampling happens *inside* resblocks (avg-pool down / nearest up on
    both the main and shortcut paths) instead of standalone layers; the
    resampling blocks gather *after* resampling with an identity epilogue
    (reference: sige_unet.py:144-152), and in the window layout the
    chain crosses them: up through the doubled carried window, down
    through the planner's pre-pool products (``wdnp_in``);
  * temb conditioning is scale-shift: ``h = h * (1 + s) + b`` after norm2,
    folded as scale2 = (1 + s) * scale, shift2 = (1 + s) * shift + b
    (reference: sige_unet.py:113-120);
  * per-block temb projections (the pd checkpoints store them per
    block), temb from a logsnr embedding;
  * multi-head attention (head_dim 64), never sparse: the attention
    blocks have no ``support_sparse`` (attn at 8/16/32 px, below the
    sparse threshold of 64), so they run on the whole map in every mode.

The resblock is :class:`~sige_torch.models.blocks.ResBlock` with
``resample`` and a (post_scale, post_shift) time embedding; the stem, the
tail and the attention block are the DDPM U-Net's. Module names follow
``sige_tpu``'s flax names, so the weight bridge and the plan trees map
one to one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...nn.module import SIGECtx, add_dense_macs
from ..blocks import ResBlock, SIGEUNetEnds, swish
from ..ddpm.unet import SIGEAttnBlock, timestep_embedding


@dataclasses.dataclass(frozen=True)
class PDUNetConfig:
    """church pd256 defaults (reference:
    diffusion/configs/church_pd256-sige.yml). The fields and defaults are
    ``sige_tpu``'s."""

    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 1, 2, 4, 6, 8)
    num_res_blocks: int = 3
    attn_resolutions: Tuple[int, ...] = (8, 16, 32)
    in_ch: int = 3
    out_ch: int = 6
    resolution: int = 256
    temb_ch: int = 768
    head_dim: Optional[int] = 64
    num_heads: Optional[int] = None
    num_groups: int = 32
    logsnr_input_type: str = "inv_cos"
    block_size_normal: Optional[int] = 6
    block_size_instance: Optional[int] = 4
    sparse_resolution_threshold: int = 64
    #: window-layout chains, also across the resampling resblocks
    window_chain: bool = True
    #: fold norm_out + window conv_out (see the DDPM U-Net)
    sige_tail: bool = True
    cache_slots: int = 1


class SIGEPDResnetBlock(ResBlock):
    """Reference: diffusion/models/pd_arch/sige_unet.py:12-175."""

    def __init__(self, cfg: PDUNetConfig, in_channels: int,
                 out_channels: int, resample: Optional[str] = None,
                 support_sparse: bool = False):
        super().__init__(in_channels, out_channels, cfg.num_groups,
                         cfg.block_size_normal if support_sparse else None,
                         cfg.block_size_instance, cfg.window_chain,
                         resample=resample)
        self.temb_proj = nn.Linear(cfg.temb_ch, 2 * out_channels)

    def forward(self, x, temb, ctx: SIGECtx):
        """``temb``: [B, temb_ch] (dense/full modes; None in sparse — its
        scale-shift lives in norm2's cached affine)."""
        def scale_shift():
            add_dense_macs(ctx, temb, 2 * self.out_channels)
            scale, shift = self.temb_proj(swish(temb)).chunk(2, dim=-1)
            return 1.0 + scale, shift

        return self._run(x, ctx, scale_shift)


def _attn_block(cfg: PDUNetConfig, channels: int) -> SIGEAttnBlock:
    if cfg.head_dim is not None:
        if cfg.num_heads is not None:
            raise ValueError("set head_dim or num_heads, not both")
        return SIGEAttnBlock(cfg, channels, heads=channels // cfg.head_dim,
                             head_dim=cfg.head_dim)
    return SIGEAttnBlock(cfg, channels, heads=cfg.num_heads)


class SIGEPDUNet(SIGEUNetEnds):
    """Reference: sige_unet.py:269-474. ``forward(x, logsnr, ctx)`` with x
    [B, H, W, in_ch] and logsnr [B]."""

    def __init__(self, cfg: PDUNetConfig = PDUNetConfig()):
        super().__init__()
        self.cfg = cfg
        nres = len(cfg.ch_mult)
        self.temb_dense0 = nn.Linear(cfg.ch, cfg.temb_ch)
        self.temb_dense1 = nn.Linear(cfg.temb_ch, cfg.temb_ch)
        self._init_stem(cfg)

        in_mult = (1,) + tuple(cfg.ch_mult)
        down_blocks, down_attns, downsamples = [], [], []
        curr_res = cfg.resolution
        block_in = None
        for i in range(nres):
            blocks, attns = [], []
            block_in = cfg.ch * in_mult[i]
            block_out = cfg.ch * cfg.ch_mult[i]
            sparse = curr_res >= cfg.sparse_resolution_threshold
            for _ in range(cfg.num_res_blocks):
                blocks.append(SIGEPDResnetBlock(cfg, block_in, block_out,
                                                support_sparse=sparse))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(_attn_block(cfg, block_in))
            down_blocks.append(nn.ModuleList(blocks))
            down_attns.append(nn.ModuleList(attns))
            if i != nres - 1:
                downsamples.append(SIGEPDResnetBlock(
                    cfg, block_in, block_in, resample="down",
                    support_sparse=sparse))
                curr_res //= 2
        self.down_blocks = nn.ModuleList(down_blocks)
        self.down_attns = nn.ModuleList(down_attns)
        self.downsamples = nn.ModuleList(downsamples)

        sparse_mid = curr_res >= cfg.sparse_resolution_threshold
        self.mid_block1 = SIGEPDResnetBlock(cfg, block_in, block_in,
                                            support_sparse=sparse_mid)
        self.mid_attn = _attn_block(cfg, block_in)
        self.mid_block2 = SIGEPDResnetBlock(cfg, block_in, block_in,
                                            support_sparse=sparse_mid)

        up_blocks, up_attns, upsamples = [], [], []
        for i in reversed(range(nres)):
            blocks, attns = [], []
            block_out = cfg.ch * cfg.ch_mult[i]
            skip_in = cfg.ch * cfg.ch_mult[i]
            sparse = curr_res >= cfg.sparse_resolution_threshold
            for ib in range(cfg.num_res_blocks + 1):
                if ib == cfg.num_res_blocks:
                    skip_in = cfg.ch * in_mult[i]
                blocks.append(SIGEPDResnetBlock(cfg, block_in + skip_in,
                                                block_out,
                                                support_sparse=sparse))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(_attn_block(cfg, block_in))
            up_blocks.insert(0, nn.ModuleList(blocks))
            up_attns.insert(0, nn.ModuleList(attns))
            if i != 0:
                upsamples.insert(0, SIGEPDResnetBlock(
                    cfg, block_in, block_out, resample="up",
                    support_sparse=sparse))
                curr_res *= 2
        self.up_blocks = nn.ModuleList(up_blocks)
        self.up_attns = nn.ModuleList(up_attns)
        self.upsamples = nn.ModuleList(upsamples)
        self._init_tail(cfg, block_in)

    def _logsnr_input(self, logsnr):
        t = self.cfg.logsnr_input_type
        if t == "sigmoid":
            return torch.sigmoid(logsnr)
        if t == "inv_cos":
            return torch.atan(torch.exp(
                -0.5 * torch.clamp(logsnr, -20.0, 20.0))) / (0.5 * math.pi)
        raise NotImplementedError(f"logsnr_input_type {t!r}")

    def _temb(self, logsnr, ctx: SIGECtx):
        cfg = self.cfg
        temb = timestep_embedding(self._logsnr_input(logsnr) * 1000.0, cfg.ch)
        add_dense_macs(ctx, temb, cfg.temb_ch)
        temb = swish(self.temb_dense0(temb))
        add_dense_macs(ctx, temb, cfg.temb_ch)
        return self.temb_dense1(temb)

    def forward(self, x, logsnr, ctx: SIGECtx):
        cfg = self.cfg
        nres = len(cfg.ch_mult)
        temb = (self._temb(logsnr, ctx) if ctx.mode in ("dense", "full")
                else None)
        hs = [self._stem(x, ctx)]
        for i in range(nres):
            for ib in range(cfg.num_res_blocks):
                h = self.down_blocks[i][ib](hs[-1], temb, ctx)
                if len(self.down_attns[i]):
                    h = self.down_attns[i][ib](h, ctx)
                hs.append(h)
            if i != nres - 1:
                hs.append(self.downsamples[i](hs[-1], temb, ctx))

        h = self.mid_block1(hs[-1], temb, ctx)
        h = self.mid_attn(h, ctx)
        h = self.mid_block2(h, temb, ctx)

        for i in reversed(range(nres)):
            for ib in range(cfg.num_res_blocks + 1):
                # the skip joins as a tuple: window chains extend each part
                h = self.up_blocks[i][ib]((h, hs.pop()), temb, ctx)
                if len(self.up_attns[i]):
                    h = self.up_attns[i][ib](h, ctx)
            if i != 0:
                h = self.upsamples[i - 1](h, temb, ctx)
        return self._tail(h, ctx)
