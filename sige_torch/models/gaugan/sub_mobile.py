"""GAN-Compression sub-mobile SPADE generator with SIGE wiring — the port
of ``sige_tpu.models.gaugan.sub_mobile``.

The compressed GauGAN family: per-layer channel counts decoded from a
``config_str`` (e.g. "32_32_32_48_32_24_24_32"), SPADE γ/β produced by
*separable* convs whose internal InstanceNorm is folded between the
depthwise and pointwise stages (reference:
gaugan/models/sub_mobile_spade_generators/
sige_fused_sub_mobile_spade_generator.py, gaugan/models/mobile_modules.py,
gaugan/models/sige_normalization.py:92-176).

InstanceNorm statistics are data-dependent, so — unlike the BatchNorm
folds of the full-size SPADE — the separable convs' affines are cached in
full mode and replayed in sparse mode (reference: mobile_modules.py:104-119).
It runs no window chains: its blocks gather and scatter around every
block, in the tile or the window layout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...nn.module import (Gather, Scatter, ScatterGather,
                          ScatterWithBlockResidual, SIGECtx, SIGEConv2d,
                          SIGEModule, share)
from ...nn.norm import batch_norm_affine, instance_norm_stats
from ..blocks import up2
from .spade import SPADEGenConfig, _leaky, nearest_resize


def decode_config(config_str: str) -> List[int]:
    """Reference: gaugan/utils.py:14-17."""
    return [int(c) for c in config_str.split("_")]


class SIGESeparableConv2d(SIGEModule):
    """Depthwise conv -> folded InstanceNorm -> pointwise conv
    (reference: gaugan/models/mobile_modules.py:65-119). The norm's
    statistics (mean, rstd) are cached in full mode and applied in sparse
    mode (see :func:`~sige_torch.nn.norm.instance_norm_stats`)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1, support_sparse: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.dw = SIGEConv2d(in_channels, in_channels, kernel_size,
                             padding=padding, groups=in_channels,
                             use_bias=use_bias, tile_input=support_sparse)
        self.pw = SIGEConv2d(in_channels, features, 1, padding=0,
                             use_bias=use_bias, tile_input=support_sparse)

    def forward(self, x, ctx: SIGECtx):
        h = self.dw(x, ctx)
        if ctx.mode in ("dense", "full"):
            mean, rstd = instance_norm_stats(h, eps=1e-5)
            if ctx.mode == "full":
                self.cache["in_mean"], self.cache["in_rstd"] = mean, rstd
        else:
            mean, rstd = self.cache["in_mean"], self.cache["in_rstd"]
        return self.pw((h - mean) * rstd, ctx)


class FusedSubMobileSPADENorm(SIGEModule):
    """SPADE norm with separable γ/β convs over ``oc`` channels
    (reference: sige_normalization.py:92-176). The param-free BatchNorm
    uses running stats (data-independent fold)."""

    def __init__(self, oc: int, nhidden: int, pairing: str = "dense",
                 seg_gather: Optional[Gather] = None,
                 shortcut_geom_gather_gamma: Optional[Gather] = None,
                 shortcut_geom_gather_beta: Optional[Gather] = None,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.pairing = pairing
        self.bn_eps = bn_eps
        self.register_buffer("running_mean", torch.zeros(oc))
        self.register_buffer("running_var", torch.ones(oc))
        sparse = pairing != "dense"
        self.mlp_gamma = SIGESeparableConv2d(nhidden, oc,
                                             support_sparse=sparse)
        self.mlp_beta = SIGESeparableConv2d(nhidden, oc, support_sparse=sparse)
        if pairing == "main":
            self.sg_gamma = ScatterGather(seg_gather)
            self.sg_beta = ScatterGather(seg_gather)
        elif pairing == "shortcut":
            self.scatter_gamma = Scatter(seg_gather)
            self.scatter_beta = Scatter(seg_gather)
            share(self, "regather_gamma", shortcut_geom_gather_gamma)
            share(self, "regather_beta", shortcut_geom_gather_beta)

    def affine(self):
        """Data-independent BN fold (scale, shift) from running stats."""
        return batch_norm_affine(self.running_mean, self.running_var,
                                 eps=self.bn_eps)

    def forward(self, x, actv, ctx: SIGECtx):
        if ctx.mode in ("dense", "full"):
            scale, shift = self.affine()
            normalized = x * scale + shift
        else:
            normalized = x
        gamma = self.mlp_gamma(actv, ctx)
        beta = self.mlp_beta(actv, ctx)
        if self.pairing == "main":
            gamma = self.sg_gamma(gamma, ctx)
            beta = self.sg_beta(beta, ctx)
        elif self.pairing == "shortcut":
            gamma = self.regather_gamma(self.scatter_gamma(gamma, ctx), ctx)
            beta = self.regather_beta(self.scatter_beta(beta, ctx), ctx)
        return normalized * (1 + gamma) + beta


class SIGESubMobileSPADEResnetBlock(SIGEModule):
    """Reference: sige_fused_sub_mobile_spade_generator.py:9-190. ``fin``
    and ``fout`` are the nominal channels (they decide the learned
    shortcut), ``ic`` the actual input channels, ``channel`` the actual
    middle channels."""

    def __init__(self, cfg: SPADEGenConfig, fin: int, fout: int, ic: int,
                 channel: int, hidden: int, support_sparse: bool = False):
        super().__init__()
        self.learned_shortcut = fin != fout
        self.main_sparse = support_sparse and cfg.main_block_size is not None
        self.shortcut_sparse = (self.main_sparse and self.learned_shortcut
                                and cfg.shortcut_block_size is not None)
        self.n_branches = 3 if self.learned_shortcut else 2
        tile = self.main_sparse
        self.mlp_shared = SIGEConv2d(cfg.semantic_nc,
                                     hidden * self.n_branches, 3, padding=1,
                                     tile_input=tile)
        out1 = channel if self.learned_shortcut else ic
        self.conv = nn.ModuleList([
            SIGEConv2d(ic, channel, 3, padding=1, tile_input=tile),
            SIGEConv2d(channel, out1, 3, padding=1, tile_input=tile)])

        seg_gather = sg_gamma = sg_beta = None
        if self.main_sparse:
            self.seg_gather = Gather(cfg.main_block_size, 3, 1, 1)
            self.seg_sg = ScatterGather(self.seg_gather)
            self.main_gather = Gather(cfg.main_block_size, 3, 1, 1)
            self.main_sg = ScatterGather(self.main_gather)
            seg_gather = self.seg_gather
        if self.learned_shortcut:
            self.conv_s = SIGEConv2d(ic, channel, 1, padding=0,
                                     use_bias=False,
                                     tile_input=self.shortcut_sparse)
            if self.shortcut_sparse:
                bs = cfg.shortcut_block_size
                self.shortcut_gather = Gather(bs, 1, 1, 0)
                self.norm_s_regather_gamma = Gather(bs, 1, 1, 0)
                self.norm_s_regather_beta = Gather(bs, 1, 1, 0)
                sg_gamma = self.norm_s_regather_gamma
                sg_beta = self.norm_s_regather_beta
                self.join = ScatterWithBlockResidual(self.main_gather,
                                                     self.shortcut_gather)
        if self.main_sparse and not self.shortcut_sparse:
            self.join = Scatter(self.main_gather)

        pairing = "main" if self.main_sparse else "dense"
        self.norm = nn.ModuleList([
            FusedSubMobileSPADENorm(c, hidden, pairing, seg_gather,
                                    bn_eps=cfg.bn_eps)
            for c in (ic, channel)])
        if self.learned_shortcut:
            self.norm_s = FusedSubMobileSPADENorm(
                ic, hidden, "shortcut" if self.shortcut_sparse else "dense",
                seg_gather, sg_gamma, sg_beta, bn_eps=cfg.bn_eps)

    def forward(self, x, seg, ctx: SIGECtx):
        sparse = ctx.mode == "sparse"
        conv_0, conv_1 = self.conv
        norm_0, norm_1 = self.norm
        seg_r = nearest_resize(seg, x.shape[1:3])
        if self.main_sparse:
            seg_r = self.seg_gather(seg_r, ctx)
        actvs = torch.relu(self.mlp_shared(seg_r, ctx))
        if self.main_sparse:
            actvs = self.seg_sg(actvs, ctx)
        actv = actvs.chunk(self.n_branches, dim=-1)

        x_s = x
        if self.learned_shortcut:
            if self.shortcut_sparse:
                fold = self.norm_s.affine() if sparse else ()
                x_s = self.shortcut_gather(x_s, ctx, *fold)
            elif sparse:
                s, b = self.norm_s.affine()
                x_s = x_s * s + b
            x_s = self.conv_s(self.norm_s(x_s, actv[2], ctx), ctx)

        dx = x
        if self.main_sparse:
            dx = self.main_gather(dx, ctx, *(norm_0.affine() if sparse
                                             else ()))
        elif sparse:
            s, b = norm_0.affine()
            dx = dx * s + b
        dx = conv_0(_leaky(norm_0(dx, actv[0], ctx)), ctx)
        if self.main_sparse:
            dx = self.main_sg(dx, ctx, *(norm_1.affine() if sparse else ()))
        elif sparse:
            s, b = norm_1.affine()
            dx = dx * s + b
        dx = conv_1(_leaky(norm_1(dx, actv[1], ctx)), ctx)

        if self.main_sparse:
            return self.join(dx, ctx, residual=x_s)
        return x_s + dx


class SIGESubMobileSPADEGenerator(SIGEModule):
    """Reference: sige_fused_sub_mobile_spade_generator.py:196-340.
    Layer channels come from ``channels`` (a decoded config_str)."""

    def __init__(self, cfg: SPADEGenConfig = SPADEGenConfig(),
                 channels: Tuple[int, ...] = (32, 32, 32, 48, 32, 24, 24, 32)):
        super().__init__()
        if cfg.num_upsampling_layers == "most":
            raise NotImplementedError("'most' is unsupported for sub-mobile")
        self.cfg = cfg
        nf = cfg.ngf
        ch = channels
        nsl = cfg.num_sparse_layers
        self.fc = SIGEConv2d(cfg.semantic_nc, 16 * ch[0], 3, padding=1,
                             tile_input=False)

        def mk(fin, fout, ic, channel, hidden, k):
            return SIGESubMobileSPADEResnetBlock(
                cfg, fin, fout, ic, channel, hidden, support_sparse=nsl >= k)

        ic = ch[0] * 16
        self.head = nn.ModuleList([
            mk(16 * nf, 16 * nf, ic, ch[1] * 16, ch[1] * 2, 7)])
        self.G_middle = nn.ModuleList([
            mk(16 * nf, 16 * nf, ic, ch[2] * 16, ch[2] * 2, 6),
            mk(16 * nf, 16 * nf, ic, ch[3] * 16, ch[3] * 2, 5)])
        self.up = nn.ModuleList([
            mk(16 * nf, 8 * nf, ic, ch[4] * 8, ch[4] * 2, 4),
            mk(8 * nf, 4 * nf, ch[4] * 8, ch[5] * 4, ch[5] * 2, 3),
            mk(4 * nf, 2 * nf, ch[5] * 4, ch[6] * 2, ch[6] * 2, 2),
            mk(2 * nf, 1 * nf, ch[6] * 2, ch[7], ch[7] * 2, 1)])
        self.conv_img = SIGEConv2d(ch[7], 3, 3, padding=1, tile_input=False)

    def forward(self, seg, ctx: SIGECtx):
        cfg = self.cfg
        x = self.fc(nearest_resize(seg, cfg.latent_hw), ctx)
        x = self.head[0](x, seg, ctx)
        x = up2(x)
        x = self.G_middle[0](x, seg, ctx)
        if cfg.num_upsampling_layers == "more":
            x = up2(x)
        x = self.G_middle[1](x, seg, ctx)
        for block in self.up:
            x = block(up2(x), seg, ctx)
        return torch.tanh(self.conv_img(_leaky(x), ctx))
