"""Vanilla (unfused) SPADE generator — the original GauGAN baseline, the
port of ``sige_tpu.models.gaugan.vanilla``.

Each SPADE norm owns its own ``mlp_shared`` / ``mlp_gamma`` / ``mlp_beta``
convs (reference: gaugan/models/spade_generators/spade_generator.py:66,
gaugan/models/normalization.py:92-131); the fused arch concatenates
those convs (fused_spade_generator.py:72-160). With weights so converted
it computes the function of
:class:`~sige_torch.models.gaugan.SIGEFusedSPADEGenerator` in ``dense``
mode. Dense only: the SIGE engine always runs the fused arch.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.module import SIGECtx, SIGEConv2d, map_res
from ..blocks import up2
from .spade import SPADEGenConfig, _leaky, nearest_resize

DENSE = SIGECtx(mode="dense")


def _conv(cin: int, cout: int, k: int = 3, **kw) -> SIGEConv2d:
    return SIGEConv2d(cin, cout, k, padding=k // 2, tile_input=False, **kw)


class VanillaSPADENorm(nn.Module):
    """Param-free BatchNorm (inference: running stats) + per-norm γ/β
    convs (reference: gaugan/models/normalization.py:92-131)."""

    def __init__(self, norm_nc: int, nhidden: int, label_nc: int,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.bn_eps = bn_eps
        self.register_buffer("running_mean", torch.zeros(norm_nc))
        self.register_buffer("running_var", torch.ones(norm_nc))
        self.mlp_shared = _conv(label_nc, nhidden)
        self.mlp_gamma = _conv(nhidden, norm_nc)
        self.mlp_beta = _conv(nhidden, norm_nc)

    def forward(self, x, seg_r, ctx: SIGECtx):
        scale = 1.0 / torch.sqrt(self.running_var + self.bn_eps)
        normalized = (x - self.running_mean) * scale
        actv = torch.relu(self.mlp_shared(seg_r, ctx))
        return (normalized * (1 + self.mlp_gamma(actv, ctx))
                + self.mlp_beta(actv, ctx))


class VanillaSPADEResnetBlock(nn.Module):
    """Reference: gaugan/models/spade_generators/spade_generator.py:9-64."""

    def __init__(self, cfg: SPADEGenConfig, fin: int, fout: int):
        super().__init__()
        fmiddle = min(fin, fout)
        nhidden = 2 * cfg.ngf
        self.learned_shortcut = fin != fout
        self.conv = nn.ModuleList([_conv(fin, fmiddle), _conv(fmiddle, fout)])
        self.norm = nn.ModuleList([
            VanillaSPADENorm(c, nhidden, cfg.semantic_nc, cfg.bn_eps)
            for c in (fin, fmiddle)])
        if self.learned_shortcut:
            self.conv_s = _conv(fin, fout, 1, use_bias=False)
            self.norm_s = VanillaSPADENorm(fin, nhidden, cfg.semantic_nc,
                                           cfg.bn_eps)

    def forward(self, x, seg, ctx: SIGECtx):
        seg_r = nearest_resize(seg, map_res(x, ctx), ctx.band)
        x_s = x
        if self.learned_shortcut:
            x_s = self.conv_s(self.norm_s(x, seg_r, ctx), ctx)
        dx = self.conv[0](_leaky(self.norm[0](x, seg_r, ctx)), ctx)
        dx = self.conv[1](_leaky(self.norm[1](dx, seg_r, ctx)), ctx)
        return x_s + dx


class VanillaSPADEGenerator(nn.Module):
    """``forward(seg)`` with seg [B, H, W, semantic_nc] one-hot(+edge)
    (reference: gaugan/models/spade_generators/spade_generator.py:66-140).
    ``ctx`` is only read for its MAC count: every mode runs dense."""

    def __init__(self, cfg: SPADEGenConfig = SPADEGenConfig()):
        super().__init__()
        self.cfg = cfg
        nf = cfg.ngf
        self.fc = _conv(cfg.semantic_nc, 16 * nf)
        self.head = nn.ModuleList([VanillaSPADEResnetBlock(cfg, 16 * nf,
                                                           16 * nf)])
        self.G_middle = nn.ModuleList([
            VanillaSPADEResnetBlock(cfg, 16 * nf, 16 * nf) for _ in range(2)])
        chans = [16 * nf, 8 * nf, 4 * nf, 2 * nf, nf]
        if cfg.num_upsampling_layers == "most":
            chans.append(nf // 2)
        self.up = nn.ModuleList([VanillaSPADEResnetBlock(cfg, a, b)
                                 for a, b in zip(chans, chans[1:])])
        self.conv_img = _conv(chans[-1], 3)

    def forward(self, seg, ctx: SIGECtx = DENSE):
        cfg = self.cfg
        x = self.fc(nearest_resize(seg, cfg.latent_hw, ctx.band), ctx)
        x = self.head[0](x, seg, ctx)
        x = up2(x)
        x = self.G_middle[0](x, seg, ctx)
        if cfg.num_upsampling_layers in ("more", "most"):
            x = up2(x)
        x = self.G_middle[1](x, seg, ctx)
        for block in self.up:
            x = block(up2(x), seg, ctx)
        return torch.tanh(self.conv_img(_leaky(x), ctx))
