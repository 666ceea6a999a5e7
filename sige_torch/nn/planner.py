"""Host-side mask planning: meta tree + mask pyramid -> plan tree.

The reference's ``SIGEModel.set_masks`` walks the module tree broadcasting
masks, each Gather reducing its resolution's mask to active indices with a
per-call memo cache (reference: sige/nn/base.py:102-108,
sige/nn/gather.py:94-108). Here the same walk happens over the meta tree
recorded by a full-mode pass: every Gather leaves its packed geometry,
input resolution, and the output resolutions its paired scatters need
source maps for. :func:`build_plan` mirrors that tree into a plan tree of
numpy arrays, which the engine moves to the device in one pass.

A numpy-only copy of the tile-layout paths of ``sige_tpu.nn.planner``:
for the same meta and masks the two produce equal plans key by key. The
window layout is planned by a later slice of the port.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..core.geometry import BlockGeometry
from ..core.masks import reduce_mask_padded
from ..core.scatter_map import bbox_of_map, build_sg_sources, build_src_map

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


def build_plan(
    meta: Mapping,
    masks: Mapping[IntPair, np.ndarray],
    bucket_min: int = 8,
    capacities: Optional[Dict[Tuple, int]] = None,
    layout: str = "tiles",
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
        (see :func:`plan_pins`).
      layout: only ``"tiles"`` in this port.

    Returns a nested dict mirroring the module tree with, at each Gather:
      ``indices`` [K, 2] int32, ``count`` int32 scalar, per scatter output
      resolution a bbox-cropped ``srcbox_{h}x{w}`` map and its
      ``srcorg_{h}x{w}`` origin, and ``sgsrc_/sgflat_{h}x{w}`` lookups per
      fused re-gather resolution.
    """
    if layout != "tiles":
        raise NotImplementedError(
            f"layout={layout!r}: the window layout is planned by a later "
            "slice of the port; use layout='tiles'")
    if _memo is None:
        _memo = {}
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
            plan[name] = entry
        elif isinstance(node, Mapping):
            sub = build_plan(node, masks, bucket_min, capacities, layout,
                             _path + (name,), _memo)
            if sub:
                plan[name] = sub
    return plan


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
                if k.startswith("srcbox_"):
                    pins[p + (k,)] = tuple(np.asarray(v).shape)
        elif isinstance(sub, Mapping):
            pins.update(plan_pins(sub, _path + (name,)))
    return pins


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
