"""Host-side mask planning: meta tree + mask pyramid -> plan tree.

The reference's ``SIGEModel.set_masks`` walks the module tree broadcasting
masks, each Gather reducing its resolution's mask to active indices with a
per-call memo cache (reference: sige/nn/base.py:102-108,
sige/nn/gather.py:94-108). Here the same walk happens over the meta tree
recorded by a full-mode pass: every Gather leaves its packed geometry,
input resolution, and the output resolutions its paired scatters need
source maps for. :func:`build_plan` mirrors that tree into a plan tree of
numpy arrays, which the engine moves to the device in one pass.

A numpy-only copy of the tile and window paths of ``sige_tpu.nn.planner``:
for the same meta and masks the two produce equal plans key by key. The
mod-16 window lattice and ``max_cover`` are copied as they are, so that
the plans stay equal. Window chains cross resolutions through three
products: ``wup_ok`` (across a nearest-2x upsample), ``wdn_ok`` (into a
stride-2 conv) and the pre-pool ``wdnp_in`` / ``wdnp_edge`` (into an
avg-pool, PD's down-resampling resblock).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..core.geometry import BlockGeometry
from ..core.masks import reduce_mask_padded
from ..core.scatter_map import (bbox_of_map, build_sg_sources,
                                build_src_map, gather_position_geom)

IntPair = Tuple[int, int]


def _unpack_geom(arr) -> BlockGeometry:
    v = [int(i) for i in np.asarray(arr).reshape(-1)]
    return BlockGeometry(
        block_size=(v[0], v[1]),
        block_stride=(v[2], v[3]),
        offset=(v[4], v[5]),
        kernel_size=(v[6], v[7]),
        conv_stride=(v[8], v[9]),
    )


def _first(recorded):
    """Recorded values accumulate as sequences; planning metadata is
    identical across records, so take the first."""
    if isinstance(recorded, (tuple, list)):
        return recorded[0]
    return recorded


def _is_gather_record(node: Mapping) -> bool:
    return isinstance(node, Mapping) and "geom" in node and "input_res" in node


def _fit_window(lo: int, hi: int, limit: int, mult: int,
                min_size: int = 0) -> Tuple[int, int]:
    """Bucket [lo, hi) into a window whose size is ≡ -2 (mod mult), so a
    stride-1 3x3 consumer's conv INPUT (size + 2 halo) lands on the
    lattice (``sige_tpu``'s TPU layout policy, copied so plans stay
    equal). ``min_size`` (extent pins) comes from previous fits, i.e. the
    same lattice.

    The start anchors at ``lo`` but nudges into [1, limit-size-1] when
    the coverage range allows, so a window that nearly fills the canvas
    keeps its stride-1 conv halo in image (2-form metas)."""
    size = min(max(-(-(hi - lo + 2) // mult) * mult - 2, min_size), limit)
    s_min = max(hi - size, 0)          # still covers [lo, hi)
    s_max = min(int(lo), limit - size)
    start = s_max
    if s_min <= s_max and size + 2 <= limit:
        h_min, h_max = max(s_min, 1), min(s_max, limit - size - 1)
        if h_min <= h_max:  # a +-1-halo-in-image start exists
            start = h_max
    return max(start, 0), size


def _mask_bounds(mask: np.ndarray, mult: int):
    H, W = mask.shape
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0:
        return 0, min(mult, H), 0, min(mult, W)
    return rows[0], rows[-1] + 1, cols[0], cols[-1] + 1


def _gather_out_reses(node, geom: BlockGeometry, in_res: IntPair):
    """Conv output resolutions of one gather record: the recorded
    scatter/sg resolutions, else the geometry's."""
    reses = {tuple(int(i) for i in np.asarray(a))
             for key in ("scatter_res", "sg_res")
             for a in node.get(key, ())}
    if not reses:
        kh, kw = geom.kernel_size
        sh, sw = geom.conv_stride
        oh, ow = geom.offset
        reses = {((in_res[0] + 2 * oh - kh) // sh + 1,
                  (in_res[1] + 2 * ow - kw) // sw + 1)}
    return reses


def _collect_window_reses(meta: Mapping) -> set:
    """Every conv-output resolution some gather windows at — the only
    resolutions canonical windows exist for (tiny mask-pyramid tails no
    gather consumes must not join the nesting, or their whole-canvas
    minimum windows cascade)."""
    out = set()
    for node in meta.values():
        if _is_gather_record(node):
            geom = _unpack_geom(_first(node["geom"]))
            in_res = tuple(int(i) for i in np.asarray(_first(node["input_res"])))
            out |= _gather_out_reses(node, geom, in_res)
        elif isinstance(node, Mapping):
            out |= _collect_window_reses(node)
    return out


def _plan_canonical_windows(masks: Mapping[IntPair, np.ndarray],
                            mult: int = 16,
                            consumed: Optional[set] = None,
                            nesting: bool = True,
                            max_cover: float = 0.75,
                            ext_pins: Optional[Mapping[IntPair, IntPair]] = None,
                            ) -> Dict[IntPair, Tuple]:
    """{res: (r0, c0, WH, WW)} — THE bucketed window every gather/scatter
    at a resolution shares (alignment keeps window joins elementwise).

    Cross-resolution nesting for window-resident chains: the window at
    (h, w) covers the ceil-half of the window at (2h, 2w) plus a 1px
    halo, so a carried window DOUBLED across an upsample covers the finer
    consumer's whole extraction window. Growth cascades to coarser
    resolutions only.

    ``consumed`` restricts the planned resolutions to those some gather
    windows at (:func:`_collect_window_reses`).

    ``max_cover`` drops resolutions whose pre-nesting bucketed window
    would cover more than that fraction of the canvas; gathers there run
    the tile layout (hybrid plan), and dropped resolutions leave the
    nesting fixpoint.

    ``ext_pins`` ({res: (WH, WW)} minimum extents) pins the windowed
    resolution set to the pinned keys and every window to at least its
    pinned extent, so plans for different masks share leaf shapes."""
    if consumed is not None:
        masks = {res: m for res, m in masks.items() if res in consumed}
    if ext_pins is not None:
        masks = {res: m for res, m in masks.items() if res in ext_pins}
    reses = sorted(masks.keys())

    def _mult(res):
        # finer bucketing at small canvases (a 16-multiple window is the
        # whole canvas at 16^2)
        return mult if min(res) >= 64 else 4

    lo: Dict[IntPair, list] = {
        res: list(_mask_bounds(np.asarray(masks[res], bool), _mult(res)))
        for res in reses}
    if max_cover < 1.0 and ext_pins is None:
        def _cover(res):
            r_lo, r_hi, c_lo, c_hi = lo[res]
            _, wh = _fit_window(r_lo, r_hi, res[0], _mult(res))
            _, ww = _fit_window(c_lo, c_hi, res[1], _mult(res))
            return (wh * ww) / float(res[0] * res[1])
        reses = [res for res in reses if _cover(res) <= max_cover]
        lo = {res: lo[res] for res in reses}

    def fit(res):
        r_lo, r_hi, c_lo, c_hi = lo[res]
        pin = ext_pins.get(res, (0, 0)) if ext_pins else (0, 0)
        r0, wh = _fit_window(r_lo, r_hi, res[0], _mult(res), pin[0])
        c0, ww = _fit_window(c_lo, c_hi, res[1], _mult(res), pin[1])
        return (r0, c0, wh, ww)

    def grow(res, r_lo, r_hi, c_lo, c_hi) -> bool:
        b = lo[res]
        want = [min(b[0], max(r_lo, 0)), max(b[1], min(r_hi, res[0])),
                min(b[2], max(c_lo, 0)), max(b[3], min(c_hi, res[1]))]
        if want != b:
            lo[res] = want
            return True
        return False

    # iterate on the FITTED extents until a fixpoint: extents only grow
    # and are canvas-capped, so this terminates
    while nesting:
        fitted = {res: fit(res) for res in reses}
        changed = False
        for res in reses:           # fine -> coarse: cover finer/2 + halo
            dbl = (res[0] * 2, res[1] * 2)
            if dbl in fitted:
                r0, c0, wh, ww = fitted[dbl]
                changed |= grow(res, r0 // 2 - 1, -(-(r0 + wh) // 2) + 1,
                                c0 // 2 - 1, -(-(c0 + ww) // 2) + 1)
        if not changed:
            break
    return {res: fit(res) for res in reses}


def _window_meta(idx0: IntPair, ext: IntPair, limit: IntPair,
                 static_fast: bool = True):
    """Meta + in-image edge mask for a (possibly virtual) window origin
    (see :mod:`sige_torch.ops.window`): the 2-form ``int32[2]`` start when
    the window is fully in image (and ``static_fast``), else the 4-form
    ``(clamped_r, clamped_c, roll_r, roll_c)``."""
    cl = [max(min(idx0[a], limit[a] - ext[a]), 0) for a in (0, 1)]
    er = (np.arange(ext[0]) + idx0[0] >= 0) & (np.arange(ext[0]) + idx0[0] < limit[0])
    ec = (np.arange(ext[1]) + idx0[1] >= 0) & (np.arange(ext[1]) + idx0[1] < limit[1])
    edge = er[:, None] & ec[None, :]
    if static_fast and all(
            0 <= idx0[a] and idx0[a] + ext[a] <= limit[a] for a in (0, 1)):
        # fully in image (an extent wider than the canvas clamps to the
        # same origin while poking out the far side: 4-form)
        return np.array([cl[0], cl[1]], np.int32), edge
    meta = np.array([cl[0], cl[1], cl[0] - idx0[0], cl[1] - idx0[1]], np.int32)
    return meta, edge


def build_plan(
    meta: Mapping,
    masks: Mapping[IntPair, np.ndarray],
    bucket_min: int = 8,
    capacities: Optional[Dict[Tuple, int]] = None,
    layout: str = "tiles",
    chain_nesting: bool = True,
    _path: Tuple = (),
    _memo: Optional[Dict] = None,
) -> Dict:
    """Build the plan tree from recorded metadata.

    Args:
      meta: the meta tree from a full-mode pass.
      masks: per-resolution boolean mask pyramid keyed (h, w)
        (from :func:`sige_torch.core.masks.downsample_mask`).
      bucket_min: smallest index-buffer capacity bucket.
      capacities: optional {path: capacity} pinning buffer sizes, and
        {path + (box leaf name,): (BH, BW)} pinning source-map box shapes
        (see :func:`plan_pins`). The window layout also reads
        ``("__winext__",)`` -> {(h, w): (WH, WW)} extent pins and
        ``("__metafast__",)`` (the meta form of pinned plans).
      layout: ``"tiles"`` or ``"window"``.
      chain_nesting: grow canonical windows so window chains nest across
        resolutions (False when the model runs no chains).

    Returns a nested dict mirroring the module tree with, at each Gather:
      ``indices`` [K, 2] int32, ``count`` int32 scalar, and either the
      tile products — per scatter output resolution a bbox-cropped
      ``srcbox_{h}x{w}`` map and its ``srcorg_{h}x{w}`` origin,
      ``sgsrc_/sgflat_{h}x{w}`` lookups per fused re-gather resolution,
      ``pixbox_/pixorg_{h}x{w}`` (the bbox-cropped pixel -> gather-position
      map) per tile-resident chain resolution — or the window products of
      :func:`_window_entry`.
    """
    if layout not in ("tiles", "window"):
        raise ValueError(f"unknown layout {layout!r}")
    if _memo is None:
        _memo = {}
    if layout == "window" and "windows" not in _memo:
        cap_pins = (capacities or {}).get(("__winext__",))
        ext_pins = None if cap_pins is None else {
            tuple(int(i) for i in k): tuple(v) for k, v in cap_pins.items()}
        _memo["windows"] = _plan_canonical_windows(
            masks, consumed=_collect_window_reses(meta),
            nesting=chain_nesting, ext_pins=ext_pins)
        _memo["chain_nesting"] = chain_nesting
        cap_fast = (capacities or {}).get(("__metafast__",))
        _memo["static_fast"] = (ext_pins is None if cap_fast is None
                                else bool(cap_fast))
    plan: Dict = {}
    for name, node in meta.items():
        if _is_gather_record(node):
            path = _path + (name,)
            geom = _unpack_geom(_first(node["geom"]))
            res = tuple(int(i) for i in np.asarray(_first(node["input_res"])))
            if res not in masks:
                raise KeyError(
                    f"no mask for resolution {res} at {'/'.join(path)}; "
                    f"available: {sorted(masks.keys())}"
                )
            cap = (capacities or {}).get(path)
            memo_key = ("idx", res, geom, cap)
            if memo_key not in _memo:
                try:
                    _memo[memo_key] = reduce_mask_padded(
                        masks[res], geom, capacity=cap, bucket_min=bucket_min
                    )
                except ValueError:
                    # edit outgrew a pinned capacity: fall back to a fresh
                    # bucket rather than failing the edit
                    _memo[memo_key] = reduce_mask_padded(
                        masks[res], geom, capacity=None,
                        bucket_min=bucket_min)
            indices, count = _memo[memo_key]
            entry = {
                "indices": np.asarray(indices, np.int32),
                "count": np.int32(count),
            }

            def _reses(key):
                return sorted({tuple(int(i) for i in np.asarray(a))
                               for a in node.get(key, ())})

            if layout == "window" and all(
                    ores in _memo["windows"]
                    for ores in _gather_out_reses(node, geom, res)):
                # hybrid layout: a gather whose output resolution was
                # dropped from the canonical-window set falls through to
                # tile products
                _window_entry(entry, node, geom, res, indices, count,
                              _reses, _memo)
                plan[name] = entry
                continue
            # Scatter source maps ship bbox-cropped: the join then costs
            # the edit's bbox, not the canvas; the box shape is bucketed
            # so similar edits share shapes.
            def _pinned_bbox(okey, kind, ores, build):
                pin = (capacities or {}).get(
                    path + (f"{kind}_{ores[0]}x{ores[1]}",))
                okey = okey + (pin,)
                if okey not in _memo:
                    try:
                        _memo[okey] = bbox_of_map(build(), size=pin)
                    except ValueError:
                        _memo[okey] = bbox_of_map(build())
                return _memo[okey]

            for ores in _reses("scatter_res"):
                org, box = _pinned_bbox(
                    ("srcmap", res, geom, cap, ores), "srcbox", ores,
                    lambda: build_src_map(indices, count, geom, ores))
                entry[f"srcbox_{ores[0]}x{ores[1]}"] = box
                entry[f"srcorg_{ores[0]}x{ores[1]}"] = org
            for ores in _reses("sg_res"):
                okey = ("sg", res, geom, cap, ores)
                if okey not in _memo:
                    _memo[okey] = build_sg_sources(indices, count, geom, ores)
                entry[f"sgsrc_{ores[0]}x{ores[1]}"] = _memo[okey][0]
                entry[f"sgflat_{ores[0]}x{ores[1]}"] = _memo[okey][1]
            # the pixel -> gather-position map of a tile-resident chain
            # (the VAE's ``tile_chain``), bbox-cropped like the source maps
            for ores in _reses("pixsrc_res"):
                org, box = _pinned_bbox(
                    ("pixsrc", res, geom, cap, ores), "pixbox", ores,
                    lambda: build_src_map(
                        indices, count, gather_position_geom(geom), ores))
                entry[f"pixbox_{ores[0]}x{ores[1]}"] = box
                entry[f"pixorg_{ores[0]}x{ores[1]}"] = org
            plan[name] = entry
        elif isinstance(node, Mapping):
            sub = build_plan(node, masks, bucket_min, capacities, layout,
                             chain_nesting, _path + (name,), _memo)
            if sub:
                plan[name] = sub
    return plan


def _window_entry(entry, node, geom: BlockGeometry, in_res, indices, count,
                  _reses, _memo) -> None:
    """Window-layout products for one gather (see
    :mod:`sige_torch.ops.window`): every gather/scatter at an output
    resolution shares one canonical bucketed window, so window joins and
    norm epilogues stay elementwise-aligned across module pairings."""
    kh, kw = geom.kernel_size
    sh, sw = geom.conv_stride
    oh, ow = geom.offset
    out_reses = sorted(set(_reses("scatter_res")) | set(_reses("sg_res")))
    if not out_reses:
        # pure re-gather: the conv output resolution follows from the
        # geometry alone
        out_reses = [(
            (in_res[0] + 2 * oh - kh) // sh + 1,
            (in_res[1] + 2 * ow - kw) // sw + 1,
        )]
    if len(out_reses) != 1:
        raise ValueError(f"window layout expects one conv output resolution "
                         f"per gather, got {out_reses}")
    ores = out_reses[0]
    if ores not in _memo["windows"]:
        raise KeyError(f"no mask for window resolution {ores}")
    r0, c0, WH, WW = _memo["windows"][ores]

    # gather input window (conv input extent incl. halo)
    fast = _memo.get("static_fast", True)
    ext = ((WH - 1) * sh + kh, (WW - 1) * sw + kw)
    v_org = (r0 * sh - oh, c0 * sw - ow)
    meta, edge = _window_meta(v_org, ext, in_res, fast)
    entry["win_in"] = meta
    entry["win_edge"] = edge
    entry["win_org"] = np.array([r0, c0], np.int32)

    def _covers(outer_org, outer_ext, note):
        """The containment the chain ops rely on (an overlay or slice
        that does not fit would be clamped and misaligned, not fail): the
        in-image part of this gather's extraction window must sit inside
        the carried window ``(outer_org, outer_ext)``."""
        lo = tuple(max(v_org[a], 0) for a in (0, 1))
        hi = tuple(min(v_org[a] + ext[a], in_res[a]) for a in (0, 1))
        ok = all(outer_org[a] <= lo[a] and hi[a] <= outer_org[a] + outer_ext[a]
                 for a in (0, 1))
        if not ok:
            raise ValueError(
                f"window nesting violated at {note}: extraction window "
                f"org={v_org} ext={ext} (in-image [{lo},{hi})) not covered "
                f"by carried window org={outer_org} ext={outer_ext}")

    # chain-across-upsample marker: the DOUBLED carried window at
    # in_res//2 covers this extraction window (window_chain_extend_up2);
    # never emitted without nesting
    half = (in_res[0] // 2, in_res[1] // 2)
    if (_memo.get("chain_nesting", True)
            and (sh, sw) == (1, 1) and half in _memo["windows"]
            and in_res[0] % 2 == 0 and in_res[1] % 2 == 0):
        hr0, hc0, HWH, HWW = _memo["windows"][half]
        _covers((2 * hr0, 2 * hc0), (2 * HWH, 2 * HWW), "wup_ok (up2 chain)")
        entry["wup_ok"] = np.int32(1)

    # chain-across-downsample marker: for a stride-2 consumer the carried
    # FINE window must sit inside this extraction window
    # (window_chain_extend overlays it)
    if (_memo.get("chain_nesting", True) and (sh, sw) == (2, 2)
            and in_res == (2 * ores[0], 2 * ores[1])
            and in_res in _memo["windows"]):
        fr0, fc0, FWH, FWW = _memo["windows"][in_res]
        if not all(v_org[a] <= o and o + e <= v_org[a] + ext[a]
                   for a, (o, e) in enumerate(((fr0, FWH), (fc0, FWW)))):
            raise ValueError(
                f"window nesting violated at wdn_ok (stride-2 chain): "
                f"carried window ({fr0},{fc0})+({FWH},{FWW}) at {in_res} "
                f"not inside extraction window org={v_org} ext={ext}")
        entry["wdn_ok"] = np.int32(1)

    # pre-pool chain products (asked for by Gather.prepool_chain): the
    # extraction window doubled to 2x the input resolution. A consumer
    # whose input is an avg-pool of a window-resident producer at 2x
    # extracts the doubled window from the producer's (window, cache)
    # state, pools it and goes on; the nesting makes the doubled window
    # cover the carried fine window (the containment window_chain_extend's
    # overlay needs, as for wdn_ok)
    dblr = (in_res[0] * 2, in_res[1] * 2)
    if (_memo.get("chain_nesting", True) and (sh, sw) == (1, 1)
            and "prepool" in node and dblr in _memo["windows"]):
        dr0, dc0, DWH, DWW = _memo["windows"][dblr]
        if not all(2 * v_org[a] <= o and o + e <= 2 * (v_org[a] + ext[a])
                   for a, (o, e) in enumerate(((dr0, DWH), (dc0, DWW)))):
            raise ValueError(
                f"window nesting violated at wdnp (pre-pool chain): "
                f"carried window ({dr0},{dc0})+({DWH},{DWW}) at {dblr} not "
                f"inside doubled extraction window "
                f"org={tuple(2 * v for v in v_org)} "
                f"ext={tuple(2 * e for e in ext)}")
        meta2, edge2 = _window_meta((2 * v_org[0], 2 * v_org[1]),
                                    (2 * ext[0], 2 * ext[1]), dblr, fast)
        entry["wdnp_in"] = meta2
        entry["wdnp_edge"] = edge2

    skey = ("srcmap", in_res, geom, None, ores, "w")
    if skey not in _memo:
        _memo[skey] = build_src_map(indices, count, geom, ores)
    cov = _memo[skey][r0:r0 + WH, c0:c0 + WW] >= 0

    for sres in _reses("scatter_res"):
        entry[f"wsc_org_{sres[0]}x{sres[1]}"] = np.array([r0, c0], np.int32)
        entry[f"wsc_cov_{sres[0]}x{sres[1]}"] = cov
    for gres in _reses("sg_res"):
        if (sh, sw) != (1, 1):
            raise ValueError("a fused re-gather requires stride 1")
        ext2 = (WH + kh - 1, WW + kw - 1)
        meta2, edge2 = _window_meta((r0 - oh, c0 - ow), ext2, gres, fast)
        entry[f"wsg_in_{gres[0]}x{gres[1]}"] = meta2
        entry[f"wsg_edge_{gres[0]}x{gres[1]}"] = edge2
        entry[f"wsg_cov_{gres[0]}x{gres[1]}"] = cov


def plan_pins(plan: Mapping, _path: Tuple = ()) -> Dict[Tuple, object]:
    """Shape pins of a built (host) plan: {gather path: tile capacity}
    plus {path + (box leaf name,): (BH, BW)} for every bbox-cropped
    source map. Feeding these back to :func:`build_plan` as
    ``capacities`` makes a later plan reproduce exactly these leaf
    shapes."""
    pins: Dict[Tuple, object] = {}
    for name, sub in plan.items():
        if isinstance(sub, Mapping) and "indices" in sub:
            p = _path + (name,)
            pins[p] = int(np.asarray(sub["indices"]).shape[0])
            for k, v in sub.items():
                if k.startswith(("srcbox_", "pixbox_")):
                    pins[p + (k,)] = tuple(np.asarray(v).shape)
        elif isinstance(sub, Mapping):
            pins.update(plan_pins(sub, _path + (name,)))
    return pins


def merge_pins(*pin_maps: Mapping) -> Dict[Tuple, object]:
    """Elementwise max over pin maps (ints and shape tuples alike): the
    smallest single pinning that fits every constituent plan (several
    sessions' plans feeding one ``set_masks(capacities=)``)."""
    out: Dict[Tuple, object] = {}
    for pins in pin_maps:
        for k, v in pins.items():
            prev = out.get(k)
            if prev is None:
                out[k] = v
            elif isinstance(v, tuple):
                out[k] = tuple(max(a, b) for a, b in zip(prev, v))
            else:
                out[k] = max(prev, v)
    return out


def choose_layout(masks: Mapping[IntPair, np.ndarray],
                  threshold: float = 3.0) -> str:
    """Pick the execution layout for one edit: "window" for a compact
    region, "tiles" when the edit is scattered.

    At the finest mask resolution, compare the mask's bounding-box area
    with the actually-covered area: the canonical window recomputes the
    whole bbox, so a bbox more than ``threshold``x the covered area would
    mostly recompute unedited pixels — the fixed-capacity tile buffers
    handle that shape of sparsity better."""
    res = max(masks.keys(), key=lambda r: r[0] * r[1])
    m = np.asarray(masks[res], bool)
    covered = int(m.sum())
    if covered == 0:
        return "window"
    rows = np.flatnonzero(m.any(axis=1))
    cols = np.flatnonzero(m.any(axis=0))
    bbox = int(rows[-1] + 1 - rows[0]) * int(cols[-1] + 1 - cols[0])
    return "window" if bbox <= threshold * covered else "tiles"


def plan_stats(meta: Mapping, plan: Mapping, _path: Tuple = ()) -> Dict[str, Dict]:
    """Per-gather sparsity statistics for logging/profiling: live tiles,
    buffer capacity, and input resolution (the reference prints block
    sparsity per gather when verbose; reference: sige/utils.py:33-36)."""
    stats: Dict[str, Dict] = {}
    for name, node in meta.items():
        if _is_gather_record(node):
            p = plan[name]
            res = tuple(int(i) for i in np.asarray(_first(node["input_res"])))
            geom = _unpack_geom(_first(node["geom"]))
            count = int(np.asarray(p["count"]))
            stats["/".join(_path + (name,))] = {
                "resolution": res,
                "block_size": geom.block_size,
                "tiles": count,
                "capacity": int(np.asarray(p["indices"]).shape[0]),
            }
        elif isinstance(node, Mapping):
            stats.update(plan_stats(node, plan.get(name, {}), _path + (name,)))
    return stats
