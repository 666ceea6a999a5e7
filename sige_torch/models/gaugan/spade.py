"""SPADE (GauGAN) generator with SIGE sparse wiring — the port of
``sige_tpu.models.gaugan.spade``.

The reference's fused-SPADE design (reference:
gaugan/models/spade_generators/sige_fused_spade_generator.py,
gaugan/models/sige_normalization.py):

  * each resblock computes ALL its SPADE γ/β branches from one shared
    segmap conv (``mlp_shared`` emitting 2-3 x nhidden channels at once);
  * the segmap branch runs sparsely through its own gather -> fused
    scatter/re-gather; per-norm ``mlp_gamma_beta`` convs emit (γ, β)
    fused as 2C channels;
  * the param-free BatchNorm uses running statistics at inference, so its
    (scale, shift) fold is data-independent — computed from the stats
    buffers, no caching (reference: sige_normalization.py:61-88);
  * the shortcut norm's γ/β tiles are scattered to the cached full map and
    re-gathered with the shortcut block geometry
    (reference: sige_normalization.py:52-57, 76-85);
  * sparsity is gated per layer counting from the output end via
    ``num_sparse_layers`` (reference: sige_fused_spade_generator.py:192-209).

In the window layout the blocks thread window chains across the bare
nearest-2x upsamples between them (``_Up2State``, the planner's
``wup_ok``), so full maps materialize only once, before ``conv_img``.
Under ``sparse_update`` (on the one cache slot: the config has no
``cache_slots``, as in ``sige_tpu``) the chains step aside and the
shortcut norms scatter their γβ, so every scatter commits its map.

Nearest resizes follow torch's ``F.interpolate`` indexing
(src = floor(dst * in / out)). Module names follow ``sige_tpu``'s flax
names as the weight bridge maps them (``head_0`` -> ``head.0``,
``conv_0`` -> ``conv.0``), so weights and plan trees map one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.module import (Gather, Scatter, ScatterGather,
                          ScatterWithBlockResidual, SIGECtx, SIGEConv2d,
                          SIGEModule, WindowState, chain_rel, map_res,
                          share)
from ...nn.norm import batch_norm_affine
from ...ops.sessions import cov_where
from ...ops.window import (window_chain_extend, window_chain_extend_up2,
                           window_extent, window_gather, window_slice)
from ..blocks import up2


@dataclasses.dataclass(frozen=True)
class SPADEGenConfig:
    """Cityscapes defaults (reference: gaugan/test.py:11-58). The fields
    and defaults are ``sige_tpu``'s."""

    ngf: int = 64
    semantic_nc: int = 36            # 35 labels + instance edge map
    crop_size: int = 512
    aspect_ratio: float = 2.0
    num_upsampling_layers: str = "more"   # "normal" | "more" | "most"
    main_block_size: Optional[int] = 6
    shortcut_block_size: Optional[int] = 4
    num_sparse_layers: int = 5
    bn_eps: float = 1e-5
    #: window-layout chains through the SPADE blocks AND the bare 2x
    #: upsamples between them (full maps materialize once, before conv_img)
    window_chain: bool = True
    #: sparse tail: conv_img on the gathered window, the 3-channel result
    #: scattered over the cached output (the reference keeps it dense)
    sige_tail: bool = True

    @property
    def latent_hw(self) -> Tuple[int, int]:
        ups = {"normal": 5, "more": 6, "most": 7}[self.num_upsampling_layers]
        sw = self.crop_size // (2 ** ups)
        sh = round(sw / self.aspect_ratio)
        return sh, sw


def nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int],
                   band=None) -> torch.Tensor:
    """Torch-convention nearest resize of NHWC ``x``: src = floor(dst * in
    / out). An integer downsample is a strided view; any other ratio
    indexes rows and columns.

    ``band``: this rank's row band (``SIGECtx.band``) when ``x`` is its
    band of a map sharded by rows: ``out_hw`` is the whole output's, and
    the result is this rank's band of it. Its source rows lie in the
    band when the whole map's rows are a whole multiple of the output's
    (every SPADE level's); any other row ratio raises."""
    H, W = x.shape[1:3]
    oh, ow = out_hw
    if band is not None:
        n, Hg = band.height(1), band.height(H)
        if Hg % oh or oh % n:
            raise ValueError(f"a nearest resize of {Hg} rows to {oh} over "
                             f"{n} row bands: the bands do not line up")
        oh //= n
    if H % oh == 0 and W % ow == 0:
        return x[:, ::H // oh, ::W // ow]
    rows = torch.arange(oh, device=x.device) * H // oh
    cols = torch.arange(ow, device=x.device) * W // ow
    return x[:, rows][:, :, cols]


class _Up2State:
    """A window chain carried across a bare nearest-2x upsample: the
    DOUBLED window of the previous block's output, at the doubled origin.
    The planner's nesting makes it cover the next block's whole extraction
    window, so the consumer slices straight out of it
    (:func:`~sige_torch.ops.window.window_chain_extend_up2`) — the
    upsample never touches the full canvas."""

    def __init__(self, win2: torch.Tensor, org2: torch.Tensor,
                 parent: WindowState):
        self.win2 = win2      # [B, 2*WH, 2*WW, C]
        self.org2 = org2      # parent origin doubled, [S, 2]
        self.parent = parent  # for the materialize fallback

    def to_map(self) -> torch.Tensor:
        return up2(self.parent.to_map())


def _chain_up2(x):
    """Chain-aware nearest-2x upsample between SPADE blocks."""
    if isinstance(x, WindowState):
        return _Up2State(up2(x.win), 2 * x.org, x)
    return up2(x)


def _to_map(x):
    """Materialize a chain state at a chain break."""
    return x.to_map() if isinstance(x, (WindowState, _Up2State)) else x


def _seg_window(seg: torch.Tensor, out_res: Tuple[int, int], meta,
                edge: torch.Tensor) -> torch.Tensor:
    """Window of ``nearest_resize(seg, out_res)`` at a gather's planned
    (possibly virtual, partly out-of-image) origin, without materializing
    the resized map: for the integer-stride downsamples of every SPADE
    level the resize is a strided view of ``seg``, so the window is a
    crop of that view (the out-of-image ring zero)."""
    return window_gather(nearest_resize(seg, out_res), meta, edge)


def _leaky(x):
    return F.leaky_relu(x, 0.2)


class FusedSPADENorm(SIGEModule):
    """One SPADE normalization: param-free BN (running stats) modulated by
    conv-generated (γ, β) from the shared segmap activations.

    ``pairing``:
      * "dense"    — full-map math in every mode;
      * "main"     — γβ tiles re-gathered via the shared seg gather's fused
        scatter/re-gather (main-path geometry);
      * "shortcut" — γβ tiles scattered onto a cached full map then
        re-gathered with the shortcut block geometry.

    In sparse mode the caller has already normalized ``x`` (the BN fold
    rides the main/shortcut gather epilogue), as the reference's
    ``normalized = x`` branch (reference: sige_normalization.py:70-72).
    """

    def __init__(self, norm_nc: int, nhidden: int, pairing: str = "dense",
                 seg_gather: Optional[Gather] = None,
                 shortcut_geom_gather: Optional[Gather] = None,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.pairing = pairing
        self.bn_eps = bn_eps
        self.register_buffer("running_mean", torch.zeros(norm_nc))
        self.register_buffer("running_var", torch.ones(norm_nc))
        self.mlp_gamma_beta = SIGEConv2d(nhidden, 2 * norm_nc, 3, padding=1,
                                         tile_input=pairing != "dense")
        share(self, "seg_gather", seg_gather)
        if pairing == "main":
            self.sg = ScatterGather(seg_gather)
        elif pairing == "shortcut":
            self.scatter = Scatter(seg_gather)
            share(self, "regather", shortcut_geom_gather)

    def affine(self):
        """Data-independent BN fold (scale, shift) from running stats."""
        return batch_norm_affine(self.running_mean, self.running_var,
                                 eps=self.bn_eps)

    def forward(self, x, actv, ctx: SIGECtx):
        if ctx.mode in ("dense", "full"):
            scale, shift = self.affine()
            normalized = x * scale + shift
        else:
            normalized = x  # already normalized via the gather epilogue
        gamma_beta = self.mlp_gamma_beta(actv, ctx)
        if self.pairing == "main":
            gamma_beta = self.sg(gamma_beta, ctx)
        elif self.pairing == "shortcut" and not (
                ctx.mode == "sparse" and not ctx.sparse_update
                and self.seg_gather.planned_window()):
            # (window layout: every gather at a resolution shares THE
            # canonical window, so the tile-geometry re-pairing is an
            # exact identity there and is skipped)
            gamma_beta = self.regather(self.scatter(gamma_beta, ctx), ctx)
        gamma, beta = gamma_beta.chunk(2, dim=-1)
        return normalized * (1 + gamma) + beta


class SIGEFusedSPADEResnetBlock(SIGEModule):
    """Reference: sige_fused_spade_generator.py:9-176."""

    def __init__(self, cfg: SPADEGenConfig, fin: int, fout: int,
                 support_sparse: bool = False):
        super().__init__()
        self.cfg = cfg
        fmiddle = min(fin, fout)
        nhidden = 2 * cfg.ngf
        self.learned_shortcut = fin != fout
        self.main_sparse = support_sparse and cfg.main_block_size is not None
        self.shortcut_sparse = (self.main_sparse and self.learned_shortcut
                                and cfg.shortcut_block_size is not None)
        self.n_branches = 3 if self.learned_shortcut else 2
        tile = self.main_sparse
        self.mlp_shared = SIGEConv2d(cfg.semantic_nc,
                                     nhidden * self.n_branches, 3, padding=1,
                                     tile_input=tile)
        self.conv = nn.ModuleList([
            SIGEConv2d(fin, fmiddle, 3, padding=1, tile_input=tile),
            SIGEConv2d(fmiddle, fout, 3, padding=1, tile_input=tile)])

        seg_gather = shortcut_geom = None
        if self.main_sparse:
            self.seg_gather = Gather(cfg.main_block_size, 3, 1, 1)
            self.seg_sg = ScatterGather(self.seg_gather)
            self.main_gather = Gather(cfg.main_block_size, 3, 1, 1)
            self.main_sg = ScatterGather(self.main_gather)
            seg_gather = self.seg_gather
        if self.learned_shortcut:
            self.conv_s = SIGEConv2d(fin, fout, 1, padding=0, use_bias=False,
                                     tile_input=self.shortcut_sparse)
            if self.shortcut_sparse:
                self.shortcut_gather = Gather(cfg.shortcut_block_size, 1, 1, 0)
                # the shortcut norm's γβ re-gather: the shortcut block
                # geometry, its own planned indices at the same resolution
                self.norm_s_regather = Gather(cfg.shortcut_block_size, 1, 1,
                                              0)
                shortcut_geom = self.norm_s_regather
                self.join = ScatterWithBlockResidual(self.main_gather,
                                                     self.shortcut_gather)
        if self.main_sparse and not self.shortcut_sparse:
            self.join = Scatter(self.main_gather)

        pairing = "main" if self.main_sparse else "dense"
        self.norm = nn.ModuleList([
            FusedSPADENorm(c, nhidden, pairing, seg_gather, bn_eps=cfg.bn_eps)
            for c in (fin, fmiddle)])
        if self.learned_shortcut:
            self.norm_s = FusedSPADENorm(
                fin, nhidden, "shortcut" if self.shortcut_sparse else "dense",
                seg_gather, shortcut_geom, bn_eps=cfg.bn_eps)

    # -- window-resident sparse path (the DDPM resblock's chain, with the
    #    seg branch and the SPADE modulation) -------------------------------
    def _extend(self, x, g: Gather, scale=None, shift=None):
        """Rebuild gather ``g``'s extraction window (+fused BN fold) from
        a carried chain state or a full map."""
        meta, edge = g.read_window()
        if isinstance(x, _Up2State):
            return window_chain_extend_up2(x.win2, x.org2, meta, edge, scale,
                                           shift)
        if isinstance(x, WindowState):
            return window_chain_extend(x.win, x.org, x.cache, meta, edge,
                                       scale, shift, rel=chain_rel(g))
        return window_gather(x, meta, edge, scale, shift)

    @staticmethod
    def _input_window(x, org, shape):
        """Canonical window of the block INPUT (the residual)."""
        if isinstance(x, _Up2State):
            # the nesting makes the doubled carried window cover it
            return window_slice(x.win2, org - x.org2, shape)
        if isinstance(x, WindowState):
            return x.win  # the same canonical window at the same resolution
        return window_slice(x, org, shape)

    def _chain_window(self, x, seg, ctx: SIGECtx) -> WindowState:
        g = self.main_gather
        conv_0, conv_1 = self.conv
        norm_0, norm_1 = self.norm
        org = g.window_origin()
        cache = self.join.cache["original"]
        res = tuple(cache.shape[1:3])
        _, cov = g.read_wsc(res)
        shape = window_extent(cov)

        # the seg branch, window-resident: the seg window straight off the
        # full-res seg map (strided), the ring off the cached actv map
        seg_win = _seg_window(seg, res, *self.seg_gather.read_window())
        actvs = self.seg_sg(torch.relu(self.mlp_shared(seg_win, ctx)), ctx)
        actv = actvs.chunk(self.n_branches, dim=-1)

        dx = self._extend(x, g, *norm_0.affine())
        dx = conv_0(_leaky(norm_0(dx, actv[0], ctx)), ctx)
        dx = self.main_sg(dx, ctx, *norm_1.affine())
        dx = conv_1(_leaky(norm_1(dx, actv[1], ctx)), ctx)

        # shortcut path + window-resident residual join
        y0w = window_slice(cache, org, shape)
        if self.learned_shortcut:
            x_s = self._extend(x, self.shortcut_gather, *self.norm_s.affine())
            x_s = self.conv_s(self.norm_s(x_s, actv[2], ctx), ctx)
            _, cov_s = self.shortcut_gather.read_wsc(res)
            y1w = window_slice(self.join.cache["residual"], org, shape)
            zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
            out = (cov_where(cov, dx + y1w, y0w)
                   + cov_where(cov_s, x_s - y1w, zero))
        else:
            out = cov_where(cov, dx + self._input_window(x, org, shape), y0w)
        return WindowState(out, cache, org)

    def forward(self, x, seg, ctx: SIGECtx):
        if (ctx.mode == "sparse" and self.main_sparse
                and self.cfg.window_chain and not ctx.sparse_update
                and self.main_gather.planned_window()
                and (not self.learned_shortcut or self.shortcut_sparse)
                and (not isinstance(x, _Up2State)
                     or "wup_ok" in self.main_gather.plan)):
            return self._chain_window(x, seg, ctx)
        x = _to_map(x)
        sparse = ctx.mode == "sparse"
        conv_0, conv_1 = self.conv
        norm_0, norm_1 = self.norm
        seg_r = nearest_resize(seg, map_res(x, ctx), ctx.band)
        if self.main_sparse:
            seg_r = self.seg_gather(seg_r, ctx)  # tiles in sparse mode
        actvs = torch.relu(self.mlp_shared(seg_r, ctx))
        if self.main_sparse:
            actvs = self.seg_sg(actvs, ctx)
        actv = actvs.chunk(self.n_branches, dim=-1)

        # ---- shortcut path --------------------------------------------
        x_s = x
        if self.learned_shortcut:
            if self.shortcut_sparse:
                fold = self.norm_s.affine() if sparse else ()
                x_s = self.shortcut_gather(x_s, ctx, *fold)
            elif sparse:
                s, b = self.norm_s.affine()
                x_s = x_s * s + b
            x_s = self.conv_s(self.norm_s(x_s, actv[2], ctx), ctx)

        # ---- main path ------------------------------------------------
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


class SIGEFusedSPADEGenerator(SIGEModule):
    """Reference: sige_fused_spade_generator.py:184-276. ``forward(seg,
    ctx)`` with seg [B, H, W, semantic_nc] one-hot(+edge) maps."""

    def __init__(self, cfg: SPADEGenConfig = SPADEGenConfig()):
        super().__init__()
        self.cfg = cfg
        nf = cfg.ngf
        is_most = 1 if cfg.num_upsampling_layers == "most" else 0
        nsl = cfg.num_sparse_layers

        def mk(fin, fout, k):
            return SIGEFusedSPADEResnetBlock(
                cfg, fin, fout, support_sparse=nsl >= k + is_most)

        self.fc = SIGEConv2d(cfg.semantic_nc, 16 * nf, 3, padding=1,
                             tile_input=False)
        self.head = nn.ModuleList([mk(16 * nf, 16 * nf, 7)])
        self.G_middle = nn.ModuleList([mk(16 * nf, 16 * nf, 6),
                                       mk(16 * nf, 16 * nf, 5)])
        # up_0 ... up_3 (up_4 for "most"), ranked 4, 3, ... from the end
        chans = [16 * nf, 8 * nf, 4 * nf, 2 * nf, nf] + [nf // 2] * is_most
        self.up = nn.ModuleList([mk(a, b, 4 - i) for i, (a, b) in
                                 enumerate(zip(chans, chans[1:]))])
        final_nc = nf // 2 if is_most else nf
        self._tail_sparse = cfg.sige_tail and cfg.main_block_size is not None
        self.conv_img = SIGEConv2d(final_nc, 3, 3, padding=1,
                                   tile_input=self._tail_sparse)
        if self._tail_sparse:
            self.out_gather = Gather(cfg.main_block_size, 3, 1, 1)
            self.out_scatter = Scatter(self.out_gather)

    def forward(self, seg, ctx: SIGECtx):
        cfg = self.cfg
        x = self.fc(nearest_resize(seg, cfg.latent_hw, ctx.band), ctx)
        x = self.head[0](x, seg, ctx)
        x = _chain_up2(x)
        x = self.G_middle[0](x, seg, ctx)
        if cfg.num_upsampling_layers in ("more", "most"):
            x = _chain_up2(x)
        x = self.G_middle[1](x, seg, ctx)
        for block in self.up:
            x = block(_chain_up2(x), seg, ctx)
        if self._tail_sparse and ctx.mode != "dense":
            return self._tail(x, ctx)
        x = _to_map(x)  # the chain's single materialize, before conv_img
        return torch.tanh(self.conv_img(_leaky(x), ctx))

    def _tail(self, x, ctx: SIGECtx):
        """Sparse conv_img: gather the final window (leaky fused into the
        extraction epilogue), conv VALID, scatter the 3-channel result
        over the cached pre-tanh output (see ``SPADEGenConfig.sige_tail``)."""
        g = self.out_gather
        if ctx.mode == "full":
            x = _to_map(x)
            g(x, ctx)  # records meta
            out = self.conv_img(_leaky(x), ctx)
            return torch.tanh(self.out_scatter(out, ctx))
        # sparse: extend a window-resident chain straight into the conv
        # input window; otherwise gather from the materialized map
        if isinstance(x, WindowState) and g.planned_window():
            meta, edge = g.read_window()
            ext = window_chain_extend(x.win, x.org, x.cache, meta, edge,
                                      activation="leaky", rel=chain_rel(g))
        else:
            ext = g(_leaky(_to_map(x)), ctx)
        return torch.tanh(self.out_scatter(self.conv_img(ext, ctx), ctx))
