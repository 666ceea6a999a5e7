"""Vanilla (unfused) DDPM U-Net — the *original-model* baseline arch, the
port of ``sige_tpu.models.ddpm.vanilla``.

The reference keeps the original Ho et al. U-Net as a separate class with
per-resblock temb projections and separate q/k/v attention convs
(reference: diffusion/models/ddpm_arch/unet.py:44-238); its "original"
configs benchmark this arch with the ``church256-ddpm-unet.pth``
checkpoint. It computes the same function as
:class:`~sige_torch.models.ddpm.SIGEFusedUNet` in ``dense`` mode (the
fused arch concatenates the temb and qkv matmuls; reference:
fused_unet.py:306-355), which is how the fuse surgery
(:func:`sige_torch.utils.convert.convert_ddpm_unet_to_fused`) is checked
without JAX.

Dense only, as in ``sige_tpu``. Module names follow ``sige_tpu``'s flax
names (``down_blocks_0_1`` there is ``down_blocks.0.1`` here), so
:func:`~sige_torch.utils.from_jax.state_dict_from_flax` loads its
parameters, and :func:`~sige_torch.utils.convert.convert_ddpm_vanilla_unet`
a reference checkpoint. Activations are NHWC at the boundary; the forward
runs in fp32 (:func:`~sige_torch.nn.engine.fp32_scope`) and its attention
is the reference's plain softmax product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.engine import fp32_scope
from .unet import DDPMUNetConfig, timestep_embedding


def _swish(x):
    return x * torch.sigmoid(x)


def _norm(cfg: DDPMUNetConfig, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(cfg.num_groups, channels, eps=1e-6)


class VanillaResnetBlock(nn.Module):
    """Reference: diffusion/models/ddpm_arch/unet.py:44-90 (NCHW inside)."""

    def __init__(self, cfg: DDPMUNetConfig, in_channels: int,
                 out_channels: int, use_conv_shortcut: bool = False):
        super().__init__()
        self.norm1 = _norm(cfg, in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = nn.Linear(cfg.temb_ch, out_channels)
        self.norm2 = _norm(cfg, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = self.nin_shortcut = None
        if in_channels != out_channels:
            if use_conv_shortcut:
                self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 3,
                                               padding=1)
            else:
                self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb):
        h = self.conv1(_swish(self.norm1(x)))
        h = h + self.temb_proj(_swish(temb))[:, :, None, None]
        h = self.conv2(_swish(self.norm2(h)))
        shortcut = self.conv_shortcut or self.nin_shortcut
        if shortcut is not None:
            x = shortcut(x)
        return x + h


class VanillaAttnBlock(nn.Module):
    """Global single-head attention with separate q/k/v 1x1 convs
    (reference: diffusion/models/ddpm_arch/unet.py:93-137)."""

    def __init__(self, cfg: DDPMUNetConfig, channels: int):
        super().__init__()
        self.norm = _norm(cfg, channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(B, C, H * W) for m in (self.q, self.k,
                                                       self.v))
        w = torch.softmax(torch.einsum("bcq,bck->bqk", q, k) * C ** -0.5,
                          dim=-1)
        out = torch.einsum("bqk,bck->bcq", w, v).reshape(B, C, H, W)
        return x + self.proj_out(out)


class VanillaDownsample(nn.Module):
    """Stride-2 conv with asymmetric (0,1,0,1) padding
    (reference: diffusion/models/ddpm_arch/unet.py:24-41)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VanillaUpsample(nn.Module):
    """Nearest 2x + 3x3 conv (reference: unet.py:8-21)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VanillaDDPMUNet(nn.Module):
    """``forward(x, t)`` with x [B, H, W, in_ch] and t [B] timesteps; the
    output is NHWC. Reference: diffusion/models/ddpm_arch/unet.py:140-238
    (the fused arch's level and block traversal)."""

    def __init__(self, cfg: DDPMUNetConfig = DDPMUNetConfig()):
        super().__init__()
        self.cfg = cfg
        nres = len(cfg.ch_mult)
        self.temb_dense0 = nn.Linear(cfg.ch, cfg.temb_ch)
        self.temb_dense1 = nn.Linear(cfg.temb_ch, cfg.temb_ch)
        self.conv_in = nn.Conv2d(cfg.in_ch, cfg.ch, 3, padding=1)

        in_mult = (1,) + tuple(cfg.ch_mult)
        down_blocks, down_attns, downsamples = [], [], []
        curr_res = cfg.resolution
        block_in = None
        for i in range(nres):
            blocks, attns = [], []
            block_in = cfg.ch * in_mult[i]
            block_out = cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks):
                blocks.append(VanillaResnetBlock(cfg, block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(VanillaAttnBlock(cfg, block_in))
            down_blocks.append(nn.ModuleList(blocks))
            down_attns.append(nn.ModuleList(attns))
            if i != nres - 1:
                downsamples.append(VanillaDownsample(block_in))
                curr_res //= 2
        self.down_blocks = nn.ModuleList(down_blocks)
        self.down_attns = nn.ModuleList(down_attns)
        self.downsamples = nn.ModuleList(downsamples)

        self.mid_block1 = VanillaResnetBlock(cfg, block_in, block_in)
        self.mid_attn = VanillaAttnBlock(cfg, block_in)
        self.mid_block2 = VanillaResnetBlock(cfg, block_in, block_in)

        up_blocks, up_attns, upsamples = [], [], []
        for i in reversed(range(nres)):
            blocks, attns = [], []
            block_out = cfg.ch * cfg.ch_mult[i]
            skip_in = cfg.ch * cfg.ch_mult[i]
            for ib in range(cfg.num_res_blocks + 1):
                if ib == cfg.num_res_blocks:
                    skip_in = cfg.ch * in_mult[i]
                blocks.append(VanillaResnetBlock(cfg, block_in + skip_in,
                                                 block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(VanillaAttnBlock(cfg, block_in))
            up_blocks.insert(0, nn.ModuleList(blocks))
            up_attns.insert(0, nn.ModuleList(attns))
            if i != 0:
                upsamples.insert(0, VanillaUpsample(block_in))
                curr_res *= 2
        self.up_blocks = nn.ModuleList(up_blocks)
        self.up_attns = nn.ModuleList(up_attns)
        self.upsamples = nn.ModuleList(upsamples)

        self.norm_out = _norm(cfg, block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    @torch.inference_mode()
    @fp32_scope()
    def forward(self, x, t):
        cfg = self.cfg
        nres = len(cfg.ch_mult)
        temb = timestep_embedding(t, cfg.ch)
        temb = self.temb_dense1(_swish(self.temb_dense0(temb)))

        hs = [self.conv_in(x.permute(0, 3, 1, 2))]
        for i in range(nres):
            for ib in range(cfg.num_res_blocks):
                h = self.down_blocks[i][ib](hs[-1], temb)
                if len(self.down_attns[i]):
                    h = self.down_attns[i][ib](h)
                hs.append(h)
            if i != nres - 1:
                hs.append(self.downsamples[i](hs[-1]))

        h = hs[-1]
        h = self.mid_block1(h, temb)
        h = self.mid_attn(h)
        h = self.mid_block2(h, temb)

        for i in reversed(range(nres)):
            for ib in range(cfg.num_res_blocks + 1):
                h = self.up_blocks[i][ib](torch.cat([h, hs.pop()], dim=1),
                                          temb)
                if len(self.up_attns[i]):
                    h = self.up_attns[i][ib](h)
            if i != 0:
                h = self.upsamples[i - 1](h)

        h = self.conv_out(_swish(self.norm_out(h)))
        return h.permute(0, 2, 3, 1).contiguous()
