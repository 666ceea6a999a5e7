"""The SIGE module protocol as PyTorch modules (tile and window layouts).

The reference implements its engine as stateful torch modules with a
broadcast mode switch and hidden per-module caches
(reference: sige/nn/base.py, gather.py, scatter.py, scatter_gather.py).
This port keeps that shape, with the conventions of ``sige_tpu.nn.module``:

  * **mode** ("dense" | "full" | "sparse") travels in a :class:`SIGECtx`
    passed to every ``forward``;
  * **caches** (the full-mode activations of the original image) live in
    the engine's :class:`~sige_torch.nn.engine.EngineState`, one dict per
    module and cache slot (``sige_tpu``'s ``cache_slots``, indexed by
    ``ctx.cache_id``); before each forward the engine binds every
    module's ``cache`` to its dict for the call's slot, so a module reads
    and writes ``self.cache`` whatever the slot;
  * **sparse_update** makes sparse-mode scatters write their output map
    into the slot, so an applied edit becomes the new baseline without a
    full pass (reference: sige/nn/scatter.py:59-60);
  * **meta** (packed geometry and resolutions) is recorded by each Gather
    in full mode in the packed form the planner reads, and the engine
    gathers it into a tree keyed by module path;
  * **plans** (tile indices, live counts, source maps, or canonical
    windows and their coverage masks) are produced host-side by
    :mod:`sige_torch.nn.planner`; the engine hands each Gather its entry,
    and paired scatters read it through the Gather (the layout of a
    Gather's entry picks the ops each module runs);
  * **pairing** (a Scatter must use its Gather's indices) is a plain
    reference to the Gather, kept outside the module registry so every
    Gather has exactly one path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.geometry import BlockGeometry
from ..ops import (conv2d_nhwc, gather_tiles, scatter_gather_tiles,
                   scatter_tiles_box,
                   scatter_with_block_residual_box,
                   window_gather, window_scatter,
                   window_scatter_block_residual, window_scatter_gather,
                   window_state_materialize)
from ..utils import trace

IntPair = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class SIGECtx:
    """Per-call engine context.

    Modes:
      * ``"dense"`` — plain inference, no caching (the baseline an
        un-instrumented model would run);
      * ``"full"`` — dense inference that also refreshes scatter caches,
        folded-norm affines, and planning metadata;
      * ``"sparse"`` — tile inference over the caches.

    ``cache_id`` is the cache slot the call reads and writes (the engine
    binds it); ``sparse_update`` makes a sparse call write its scattered
    maps into that slot. ``cache_dtype`` is the storage dtype of the
    scatter caches (None: the compute dtype): the scatters store their
    maps narrowed to it, and every op that reads one computes in the
    dtype of the fresh values, casting the cached part as it copies or
    slices it, so fresh regions stay in the compute dtype and only cached
    content carries the narrow rounding. The folded-norm affines and K/V
    projections keep the compute dtype. ``macs``, when a list, collects
    the analytic MACs of every layer the call runs (the port of the
    ``"profile"`` collection).

    ``band``, in a forward whose rows are sharded over ranks
    (``sige_torch.parallel.spatial``), is this rank's row band: the layers
    reach the other ranks only through its methods (``halo``,
    ``all_reduce``, ``gather_rows``, ``height``, ``cache_rows``); None on
    one card. Sparse mode runs on one card and refuses a band.
    """

    mode: str = "full"
    cache_id: int = 0
    sparse_update: bool = False
    cache_dtype: Optional[torch.dtype] = None
    macs: Optional[List[float]] = None
    band: Optional[Any] = None

    def __post_init__(self):
        if self.mode == "sparse" and self.band is not None:
            raise ValueError("sparse mode runs on one card: a sharded full "
                             "pass hands its caches to one card "
                             "(parallel/spatial.py)")


def _pair(v) -> IntPair:
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


def map_res(x: torch.Tensor, ctx: SIGECtx) -> IntPair:
    """The (H, W) of NHWC map ``x`` as the whole canvas has it: under a
    row band, the global height."""
    h, w = x.shape[1:3]
    return (h if ctx.band is None else ctx.band.height(h), w)


def add_macs(ctx: SIGECtx, n: float) -> None:
    """Record analytic MACs when the call collects them."""
    if ctx.macs is not None:
        ctx.macs.append(float(n))


def add_dense_macs(ctx: SIGECtx, x: torch.Tensor, features: int) -> None:
    """MACs of a linear layer applied to ``x``:
    ``prod(batch_dims) * in_features * out_features``."""
    add_macs(ctx, math.prod(x.shape[:-1]) * x.shape[-1] * features)


def share(mod: nn.Module, name: str, other: nn.Module) -> None:
    """Keep a reference to a module owned elsewhere without registering it
    as a child (a Scatter's Gather)."""
    object.__setattr__(mod, name, other)


class SIGEModule(nn.Module):
    """Base for engine layers: a ``cache`` dict of full-mode tensors, the
    dict of the slot the current call runs (the engine binds it). A cache
    holds the activation itself, not a copy: activations are never
    written in place, and a write replaces the slot's entry."""

    def __init__(self):
        super().__init__()
        self.cache: Dict[str, torch.Tensor] = {}

    def store(self, name: str, value: torch.Tensor, ctx: SIGECtx) -> None:
        """Write a scatter cache at the call's storage dtype (the tensor
        itself when it already has that dtype); under a row band it is
        the band's rows."""
        dtype = ctx.cache_dtype
        self.cache[name] = (value if dtype is None or value.dtype == dtype
                            else value.to(dtype))
        if ctx.band is not None:
            ctx.band.cache_rows(self.cache, name)


class WindowState:
    """Carried state of a window-resident chain: the canonical window of
    the current layer's output, the cache that supplies the rest of the
    map, and the window's origin (an int64 [S, 2] device tensor). The
    triple is the exact full map (inside the window the carried values,
    outside the cache — they agree on the uncovered interior), so
    consumers rebuild any extraction window from a window-sized cache
    slice plus one overlay, and full maps materialize only at chain
    breaks (see the chain ops of :mod:`sige_torch.ops.window`)."""

    def __init__(self, win: torch.Tensor, cache: torch.Tensor,
                 org: torch.Tensor):
        self.win = win          # [B, WH, WW, C]
        self.cache = cache      # [B, H, W, C]
        self.org = org          # [S, 2] (r0, c0)

    def to_map(self) -> torch.Tensor:
        return window_state_materialize(self.cache, self.win, self.org)


class TileState:
    """Carried state of a tile-resident chain (the VAE's ``tile_chain``,
    tile layout): the raw block output evaluated at the shared gather
    positions ([B * K, bh, bw, C]), plus what a consumer needs to
    materialize the full map: the join's cache and the bbox-cropped
    pixel -> gather-position map with its origin ([S, BH, BW], [S, 2])."""

    def __init__(self, tiles: torch.Tensor, y0: torch.Tensor, pix_box,
                 pix_org):
        self.tiles = tiles
        self.y0 = y0
        self.pix_box = pix_box
        self.pix_org = pix_org

    def to_map(self) -> torch.Tensor:
        return scatter_tiles_box(self.tiles, self.y0, self.pix_box,
                                 self.pix_org)


def chain_rel(gather: "Gather"):
    """The carried window's offset inside ``gather``'s extraction window,
    when it does not depend on the plan: for a stride-1 consumer it is the
    conv offset. None for strided gathers."""
    g = gather.geom
    return g.offset if g.conv_stride == (1, 1) else None


class Gather(SIGEModule):
    """Records geometry/resolution in full mode; extracts the active tile
    batch (with optional fused norm epilogue) in sparse mode
    (reference: sige/nn/gather.py).

    Also the anchor for planning products: the engine sets ``plan``, the
    device tensors of this Gather's entry of the installed plan. Every
    leaf leads with the plan's S >= 1 sessions: origins and window metas
    are int64 ``[S, k]``, masks and maps ``[S, ...]``; their shapes (the
    pinned extents and the meta form) are the same for every session.

    ``prepool_chain`` asks the planner for the pre-pool chain products
    (``wdnp_in`` / ``wdnp_edge``): the extraction window doubled to 2x the
    input resolution, for a consumer whose input is an avg-pool of a
    window-resident producer (PD's down-resampling resblock)."""

    def __init__(self, block_size: Union[int, IntPair] = 6,
                 kernel_size: Union[int, IntPair] = 3,
                 conv_stride: Union[int, IntPair] = 1,
                 conv_padding: Union[int, IntPair] = 0,
                 activation: str = "identity", prepool_chain: bool = False):
        super().__init__()
        self.geom = BlockGeometry.create(block_size, kernel_size, conv_stride,
                                         conv_padding)
        self.activation = activation
        self.prepool_chain = prepool_chain
        self.meta: Optional[Dict[str, Tuple[np.ndarray, ...]]] = None
        self.plan: Dict[str, torch.Tensor] = {}

    def forward(self, x, ctx: SIGECtx, scale=None, shift=None):
        if ctx.mode == "dense":
            return x
        if ctx.mode == "full":
            if scale is not None or shift is not None:
                raise ValueError(
                    "full mode never fuses epilogues; apply the norm densely")
            g = self.geom
            self.meta = {
                "input_res": (np.array(map_res(x, ctx), np.int32),),
                "geom": (np.array([*g.block_size, *g.block_stride, *g.offset,
                                   *g.kernel_size, *g.conv_stride], np.int32),),
            }
            if self.prepool_chain:
                self.meta["prepool"] = (np.int32(1),)
            return x
        if ctx.mode == "sparse":
            with trace.span("sige.op.gather"):
                if self.planned_window():
                    meta, edge = self.read_window()
                    return window_gather(x, meta, edge, scale, shift,
                                         self.activation)
                return gather_tiles(x, self.plan["indices"],
                                    self.plan["count"], self.geom, scale,
                                    shift, self.activation)
        raise ValueError(f"unknown mode {ctx.mode}")

    # --- services for paired scatters --------------------------------------
    def _request(self, key: str, res) -> None:
        self.meta[key] = self.meta.get(key, ()) + (
            np.array(tuple(res), np.int32),)

    def request_src_map(self, res) -> None:
        self._request("scatter_res", res)

    def request_sg(self, res) -> None:
        self._request("sg_res", res)

    def request_pixsrc(self, res) -> None:
        self._request("pixsrc_res", res)

    def read_src_map(self, res):
        """(box [S, BH, BW], origin [S, 2]): the bbox-cropped source map
        and its origin (see planner)."""
        key = f"{res[0]}x{res[1]}"
        return self.plan[f"srcbox_{key}"], self.plan[f"srcorg_{key}"]

    def read_sg(self, res):
        key = f"{res[0]}x{res[1]}"
        return self.plan[f"sgsrc_{key}"], self.plan[f"sgflat_{key}"]

    def read_pixsrc(self, res):
        """(box [S, BH, BW], origin [S, 2]): the bbox-cropped pixel ->
        gather-position map of a tile-resident chain and its origin (see
        planner)."""
        key = f"{res[0]}x{res[1]}"
        return self.plan[f"pixbox_{key}"], self.plan[f"pixorg_{key}"]

    # --- window layout (ops/window.py; planner layout="window") ----------
    def planned_window(self) -> bool:
        return "win_in" in self.plan

    def read_window(self):
        """(meta [S, 2 or 4], edge mask [S, EH, EW]) of the conv input
        window."""
        return self.plan["win_in"], self.plan["win_edge"]

    def read_prepool(self):
        """(meta, edge mask) of the extraction window doubled to 2x the
        input resolution (``prepool_chain``)."""
        return self.plan["wdnp_in"], self.plan["wdnp_edge"]

    def window_origin(self):
        return self.plan["win_org"]

    def read_wsc(self, res):
        """(origin [S, 2], coverage mask [S, WH, WW]) of the canonical
        window at output resolution ``res``."""
        key = f"{res[0]}x{res[1]}"
        return self.plan[f"wsc_org_{key}"], self.plan[f"wsc_cov_{key}"]

    def read_wsg(self, res):
        key = f"{res[0]}x{res[1]}"
        return (self.plan[f"wsg_in_{key}"], self.plan[f"wsg_edge_{key}"],
                self.plan[f"wsg_cov_{key}"])


class Scatter(SIGEModule):
    """Caches full-mode output; scatters fresh tiles over the cache in
    sparse mode (reference: sige/nn/scatter.py:9-63)."""

    def __init__(self, gather: Gather):
        super().__init__()
        share(self, "gather", gather)

    def forward(self, x, ctx: SIGECtx, residual=None):
        if ctx.mode == "dense":
            return x if residual is None else x + residual
        if ctx.mode == "full":
            out = x if residual is None else x + residual
            self.gather.request_src_map(map_res(out, ctx))
            self.store("original", out, ctx)
            return out
        if ctx.mode == "sparse":
            with trace.span("sige.op.scatter"):
                y = self.cache["original"]
                if self.gather.planned_window():
                    org, cov = self.gather.read_wsc(y.shape[1:3])
                    out = window_scatter(x, y, org, cov, residual)
                else:
                    box, org = self.gather.read_src_map(y.shape[1:3])
                    out = scatter_tiles_box(x, y, box, org, residual)
                if ctx.sparse_update:
                    self.store("original", out, ctx)
                return out
        raise ValueError(f"unknown mode {ctx.mode}")


class ScatterGather(SIGEModule):
    """Fused scatter->re-gather between the two convs of a resblock, with
    the second norm folded into the epilogue
    (reference: sige/nn/scatter_gather.py)."""

    def __init__(self, gather: Gather, activation: str = "identity"):
        super().__init__()
        share(self, "gather", gather)
        self.activation = activation

    def forward(self, x, ctx: SIGECtx, scale=None, shift=None):
        if ctx.mode == "dense":
            return x
        if ctx.mode == "full":
            res = map_res(x, ctx)
            self.gather.request_src_map(res)
            self.gather.request_sg(res)
            self.store("original", x, ctx)
            return x
        if ctx.mode == "sparse":
            with trace.span("sige.op.scatter_gather"):
                y = self.cache["original"]
                res = y.shape[1:3]
                if self.gather.planned_window():
                    meta, edge, cov = self.gather.read_wsg(res)
                    out = window_scatter_gather(
                        x, y, meta, edge, cov, self.gather.geom.offset, scale,
                        shift, self.activation)
                    if ctx.sparse_update:  # the fused op never forms the map
                        org, wcov = self.gather.read_wsc(res)
                        self.store("original", window_scatter(x, y, org, wcov),
                                   ctx)
                    return out
                sg_src, sg_flat = self.gather.read_sg(res)
                out = scatter_gather_tiles(
                    x, y, sg_src, sg_flat, self.gather.geom, scale, shift,
                    self.activation)
                if ctx.sparse_update:
                    box, org = self.gather.read_src_map(res)
                    self.store("original",
                               scatter_tiles_box(x, y, box, org), ctx)
                return out
        raise ValueError(f"unknown mode {ctx.mode}")


class ScatterWithBlockResidual(SIGEModule):
    """Residual join for main/shortcut paths gathered with different block
    sizes (reference: sige/nn/scatter.py:66-136)."""

    def __init__(self, main_gather: Gather, shortcut_gather: Gather):
        super().__init__()
        share(self, "main_gather", main_gather)
        share(self, "shortcut_gather", shortcut_gather)

    def forward(self, x, ctx: SIGECtx, residual=None):
        if ctx.mode == "dense":
            return x + residual
        if ctx.mode == "full":
            out = x + residual
            res = map_res(out, ctx)
            self.main_gather.request_src_map(res)
            self.shortcut_gather.request_src_map(res)
            self.store("original", out, ctx)
            self.store("residual", residual, ctx)
            return out
        if ctx.mode == "sparse":
            with trace.span("sige.op.block_residual"):
                y0 = self.cache["original"]
                y1 = self.cache["residual"]
                res = y0.shape[1:3]
                if self.main_gather.planned_window():
                    org, cov_m = self.main_gather.read_wsc(res)
                    _, cov_s = self.shortcut_gather.read_wsc(res)
                    out = window_scatter_block_residual(
                        x, y0, residual, y1, org, cov_m, cov_s)
                    if ctx.sparse_update:
                        self.store("original", out, ctx)
                        self.store("residual", window_scatter(
                            residual, y1, org, cov_s), ctx)
                    return out
                m_box, m_org = self.main_gather.read_src_map(res)
                s_box, s_org = self.shortcut_gather.read_src_map(res)
                out = scatter_with_block_residual_box(
                    x, y0, residual, y1, m_box, m_org, s_box, s_org)
                if ctx.sparse_update:
                    self.store("original", out, ctx)
                    self.store("residual", scatter_tiles_box(
                        residual, y1, s_box, s_org), ctx)
                return out
        raise ValueError(f"unknown mode {ctx.mode}")


class SIGEConv2d(SIGEModule):
    """Conv that pads normally in full/dense mode and runs VALID on
    gathered tiles in sparse mode (reference: sige/nn/base.py:80-92).
    The weight is stored as ``F.conv2d``'s OIHW ([features, in_channels /
    groups, kh, kw]); inputs are NHWC.

    ``tile_input=False`` marks a conv that always sees full maps (e.g. the
    stem conv, or resblock convs at non-sparse levels) so it keeps its
    padding in sparse mode. ``groups`` is flax's ``feature_group_count``
    (``in_channels`` for a depthwise conv); ``use_bias=False`` drops the
    bias (GauGAN's shortcut convs). Under a row band (dense and full
    mode) the conv exchanges its halo rows with the neighbouring ranks.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Union[int, IntPair] = 3,
                 stride: Union[int, IntPair] = 1, padding: Any = 0,
                 tile_input: bool = True, groups: int = 1,
                 use_bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = stride
        self.padding = padding
        self.tile_input = tile_input
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(features, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, ctx: SIGECtx):
        if ctx.mode in ("full", "dense") or not self.tile_input:
            padding = self.padding
        else:
            padding = 0
        with (trace.span("sige.op.conv") if ctx.mode == "sparse"
              else trace.OFF):
            out = conv2d_nhwc(x, self.weight, self.bias, stride=self.stride,
                              padding=padding, groups=self.groups,
                              band=ctx.band)
        # per output element, kh * kw * (C_in / groups) multiply-adds
        _, cin, kh, kw = self.weight.shape
        add_macs(ctx, out.numel() * kh * kw * cin)
        return out
