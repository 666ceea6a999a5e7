"""Stateful wrapper around a SIGE-wired torch module.

Mirrors the reference's whole-model API — ``set_mode`` is implicit in
which method you call, plus ``set_masks`` / ``clear_cache``
(reference: sige/nn/base.py:95-129) — and the methods of
``sige_tpu.nn.engine.SIGEModel``: :meth:`full` and :meth:`sparse` run the
module eagerly under ``torch.inference_mode``; :meth:`set_masks` plans on
the host and moves the plan's leaves to the device in one copy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .module import Gather, SIGECtx, SIGEModule
from .planner import build_plan, choose_layout, plan_stats


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one, only an explicit ``"cpu"``
    runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with a later slice of the "
        "port (see ROADMAP.md); this slice runs fp32 caches, one per module")


def _set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _get_path(tree: Mapping, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def upload_plan(plan: Mapping, device: torch.device) -> Dict:
    """The plan tree with every leaf a tensor on ``device``, moved in ONE
    copy: the leaves are packed into one int64 buffer and split into views
    on the device; bool leaves (window coverage and edge masks) are cast
    back to bool there."""
    leaves = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), np.asarray(v)))

    walk(plan, ())
    flat = np.concatenate([a.reshape(-1).astype(np.int64) for _, a in leaves]
                          or [np.zeros(0, np.int64)])
    buf = torch.from_numpy(flat).to(device)
    out: Dict = {}
    pos = 0
    for path, a in leaves:
        t = buf[pos:pos + a.size].view(a.shape)
        _set_path(out, path, t.bool() if a.dtype == np.bool_ else t)
        pos += a.size
    return out


class SIGEModel:
    """Holds a SIGE-wired module, its caches and its plan.

    Typical flow (reference: example.py):
        model = SIGEModel(module, device="cuda")
        model.init(seed=0)                   # or load_state_dict
        y0 = model.full(x_original)          # refresh caches, record meta
        model.set_masks(mask_pyramid)        # host planning
        y1 = model.sparse(x_edited)          # sparse inference

    ``layout``: ``"tiles"`` (fixed-capacity tile buffers — scattered
    multi-region edits), ``"window"`` (one contiguous bucketed crop
    window per resolution — compact edits; see ops/window.py), or
    ``"auto"`` (picked per edit by :func:`~.planner.choose_layout`;
    ``active_layout`` records the choice). ``chain_nesting=False`` when
    the model runs no window chains (skips the planner's
    cross-resolution window growth).
    """

    def __init__(self, module: nn.Module, bucket_min: int = 2,
                 layout: str = "tiles", chain_nesting: bool = True,
                 cache_dtype=None, device=None):
        if layout not in ("tiles", "window", "auto"):
            raise ValueError(f"unknown layout {layout!r}")
        if cache_dtype is not None:
            raise _later("cache_dtype")
        if getattr(getattr(module, "cfg", None), "cache_slots", 1) != 1:
            raise _later("cache_slots > 1")
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval().requires_grad_(False)
        self.bucket_min = bucket_min
        self.layout = layout
        self.active_layout = layout
        self.chain_nesting = chain_nesting
        self.meta: Optional[Dict] = None
        self.plan: Dict = {}
        self.plan_host: Optional[Dict] = None
        self._input_sig = None
        self._gathers = [(tuple(name.split(".")), m)
                         for name, m in module.named_modules()
                         if isinstance(m, Gather)]

    def init(self, seed: int = 0) -> None:
        """Seeded parameters: lecun-normal conv and linear weights (the
        flax default initializer, untruncated), zero biases, unit norm
        scales. Drawn on the CPU from one ``torch.Generator`` so every
        device gets the same weights."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.module.named_parameters():
            if name.endswith("bias"):
                val = torch.zeros(p.shape)
            elif p.ndim == 1:
                val = torch.ones(p.shape)
            else:  # OIHW conv or [out, in] linear: fan_in = numel / out
                fan_in = p[0].numel()
                val = torch.randn(p.shape, generator=gen) * fan_in ** -0.5
            p.data.copy_(val)

    def _gathers_meta(self) -> Dict:
        meta: Dict = {}
        for path, g in self._gathers:
            if g.meta is not None:
                _set_path(meta, path, g.meta)
        return meta

    @torch.inference_mode()
    def full(self, *args, **kwargs):
        """Dense pass on the original input: refreshes every scatter cache
        and the planning metadata. A new input shape drops the stale plan."""
        sig = tuple(tuple(a.shape) if hasattr(a, "shape") else a
                    for a in args)
        if sig != self._input_sig:
            if self._input_sig is not None:
                self.plan, self.plan_host = {}, None
            self._input_sig = sig
            self.meta = None
        y = self.module(*args, ctx=SIGECtx(mode="full"), **kwargs)
        if self.meta is None:
            self.meta = self._gathers_meta()
        return y

    def set_masks(self, masks: Mapping, capacities: Optional[Dict] = None):
        """Host-side planning: mask pyramid -> indices/source maps or
        windows, moved to the device and handed to every Gather.
        ``capacities`` pins buffer and box shapes (see
        :func:`~.planner.plan_pins`)."""
        if self.meta is None:
            raise RuntimeError("run a full() pass before set_masks()")
        layout = self.layout
        if layout == "auto":
            layout = choose_layout(masks)
        self.active_layout = layout
        plan = build_plan(self.meta, masks, self.bucket_min, capacities,
                          layout=layout, chain_nesting=self.chain_nesting)
        dev = upload_plan(plan, self.device)
        for path, g in self._gathers:
            g.plan_host = _get_path(plan, path)
            g.plan = _get_path(dev, path)
        self.plan_host, self.plan = plan, dev
        return plan

    @torch.inference_mode()
    def sparse(self, *args, sparse_update: bool = False, **kwargs):
        """Sparse inference on the edited input."""
        if sparse_update:
            raise _later("sparse_update")
        if not self.plan:
            raise RuntimeError("call set_masks() before sparse()")
        return self.module(*args, ctx=SIGECtx(mode="sparse"), **kwargs)

    @torch.inference_mode()
    def dense(self, *args, **kwargs):
        """Plain dense inference (the baseline), no caching."""
        return self.module(*args, ctx=SIGECtx(mode="dense"), **kwargs)

    def clear_cache(self) -> None:
        for m in self.module.modules():
            if isinstance(m, SIGEModule):
                m.cache.clear()

    def stats(self) -> Dict[str, Any]:
        """Per-gather sparsity statistics for the current plan."""
        if self.meta is None or self.plan_host is None:
            return {}
        return plan_stats(self.meta, self.plan_host)
