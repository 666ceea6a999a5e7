"""Stateful wrapper around a SIGE-wired torch module.

Mirrors the reference's whole-model API — ``set_mode`` is implicit in
which method you call, plus ``set_masks`` / ``clear_cache``
(reference: sige/nn/base.py:95-129) — and the methods of
``sige_tpu.nn.engine.SIGEModel``: :meth:`full` and :meth:`sparse` run the
module eagerly under ``torch.inference_mode``, on cache slot
``cache_id`` (``sparse_update`` commits an edit into its slot);
:meth:`set_masks` plans on the host and moves the plan's leaves to the
device in one copy; :meth:`SIGEModel.pin_capacities` freezes the current
plan's tile-layout shapes for later edits. An :class:`EngineState` holds
one session's caches, plan and pins; :meth:`SIGEModel.use` switches
sessions by reference. ``cache_dtype`` narrows the storage of the
scatter caches (see :class:`~.module.SIGECtx`).

Every forward runs inside :func:`fp32_scope`: PyTorch's defaults run
cuDNN convolutions in TF32 and let cuDNN pick its algorithms by
heuristic, and the engine holds fp32 (the 1e-4 contract of ``sige_tpu``)
and times its algorithms per shape (``cudnn.benchmark``, as the
reference's diffusion suite sets it, with at most
:data:`BENCHMARK_LIMIT` algorithms timed per new shape) for its own calls
only.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .module import Gather, SIGECtx, SIGEModule
from .planner import build_plan, choose_layout, plan_pins, plan_stats


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one, only an explicit ``"cpu"``
    runs."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return device


def _has_fp32_precision() -> bool:
    """torch >= 2.9 has the ``fp32_precision`` API beside the legacy
    ``allow_tf32`` flags."""
    cudnn = torch.backends.cudnn
    return hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision")


#: How many of cuDNN's algorithms benchmark mode times for each conv shape
#: new to the process (``torch.backends.cudnn.benchmark_limit``; PyTorch's
#: default is 10), inside the engine's forwards. Every new edit brings new
#: window shapes, and timing fewer algorithms cuts what it costs; one
#: algorithm is too few (cuDNN's first choice for some window shapes of
#: the SD decoder is an FFT algorithm slower than the dense conv that
#: takes GBs of workspace). Chosen by the rule of
#: ``scripts/retime_cost.py --repeat`` from six card runs per setting
#: (PERF.md section 5).
BENCHMARK_LIMIT = 2

Flags = Tuple[str, str, bool, Optional[int]]


def precision_flags() -> Flags:
    """(cuDNN conv fp32 precision, CUDA matmul fp32 precision, cuDNN
    benchmark mode, cuDNN benchmark limit) as set now. The precisions are
    read through ``fp32_precision`` where this torch has it ("ieee",
    "tf32" or "none", which inherits) and else from the legacy
    ``allow_tf32`` flags ("tf32" or "ieee"): torch refuses to mix the two
    APIs. The limit reads None where torch has no cuDNN (a CPU build)."""
    b = torch.backends
    if _has_fp32_precision():
        precisions = (b.cudnn.conv.fp32_precision,
                      b.cuda.matmul.fp32_precision)
    else:
        precisions = ("tf32" if b.cudnn.allow_tf32 else "ieee",
                      "tf32" if b.cuda.matmul.allow_tf32 else "ieee")
    return (*precisions, b.cudnn.benchmark, b.cudnn.benchmark_limit)


def set_precision_flags(flags: Flags) -> None:
    """Set what :func:`precision_flags` reads, through the same API."""
    b = torch.backends
    conv, matmul, benchmark, limit = flags
    if _has_fp32_precision():
        b.cudnn.conv.fp32_precision = conv
        b.cuda.matmul.fp32_precision = matmul
    else:
        b.cudnn.allow_tf32 = conv == "tf32"
        b.cuda.matmul.allow_tf32 = matmul == "tf32"
    b.cudnn.benchmark = benchmark
    b.cudnn.benchmark_limit = limit


@contextlib.contextmanager
def fp32_scope():
    """cuDNN convs and CUDA matmuls in full fp32 and cuDNN's benchmark
    mode, timing at most :data:`BENCHMARK_LIMIT` algorithms (read when the
    scope is entered) per new conv shape, inside; the caller's settings
    restored on exit. Without benchmark mode cuDNN's heuristic picks, for
    some window shapes, an FFT algorithm slower than the dense conv that
    takes GBs of workspace; with it each new conv shape is timed once per
    process, which a new edit's window shapes pay on its first call
    (PERF.md section 5)."""
    saved = precision_flags()
    set_precision_flags(("ieee", "ieee", True, BENCHMARK_LIMIT))
    try:
        yield
    finally:
        set_precision_flags(saved)


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


@dataclasses.dataclass
class EngineState:
    """One editing session's state in a :class:`SIGEModel`: the caches
    (for each SIGE layer, by module path, one dict per cache slot), the
    plan on the device and on the host, the layout it was built in, and
    the session's shape pins (:meth:`SIGEModel.pin_capacities`: kept per
    session, so one session's pins never shape another's plan).
    :meth:`SIGEModel.use` switches the model to a state by reference: no
    cache tensor is copied."""

    caches: Dict[str, List[Dict[str, torch.Tensor]]]
    active_layout: str
    plan: Dict = dataclasses.field(default_factory=dict)
    plan_host: Optional[Dict] = None
    pins: Dict = dataclasses.field(default_factory=dict)

    def fork(self) -> "EngineState":
        """A state that shares this one's cache tensors and plan but owns
        its slot dicts and pins: a write into either (a full pass, a
        sparse pass with ``sparse_update``, or new pins) changes its own
        and leaves the other as it was."""
        return EngineState(
            {path: [dict(d) for d in slots]
             for path, slots in self.caches.items()},
            self.active_layout, self.plan, self.plan_host, dict(self.pins))

    def tensors(self, slot: Optional[int] = None) -> List[torch.Tensor]:
        """The cache tensors, of one slot or of all."""
        return [t for slots in self.caches.values()
                for d in (slots if slot is None else slots[slot:slot + 1])
                for t in d.values()]


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

    Caches, plan and ``active_layout`` live in :attr:`state` (an
    :class:`EngineState`); :meth:`new_state` and :meth:`use` hold several
    sessions on one model and switch between them. The module's
    ``cfg.cache_slots`` sets the slots per cache (one where the config
    has no such field, as GauGAN's); ``full`` and ``sparse`` take the slot
    as ``cache_id``.

    ``cache_dtype`` (e.g. ``torch.bfloat16``) is the storage dtype of the
    scatter caches: it halves what the caches of an fp32 model hold, and
    only cached content carries its rounding (fresh regions are computed
    in the compute dtype; the folded-norm affines and K/V caches keep
    it). None keeps the caches at the compute dtype.
    """

    def __init__(self, module: nn.Module, bucket_min: int = 2,
                 layout: str = "tiles", chain_nesting: bool = True,
                 cache_dtype: Optional[torch.dtype] = None, device=None):
        if layout not in ("tiles", "window", "auto"):
            raise ValueError(f"unknown layout {layout!r}")
        self.cache_dtype = cache_dtype
        self.cache_slots = getattr(getattr(module, "cfg", None),
                                   "cache_slots", 1)
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval().requires_grad_(False)
        self.bucket_min = bucket_min
        self.layout = layout
        self.chain_nesting = chain_nesting
        self.meta: Optional[Dict] = None
        self._input_sig = None
        self._sige = [(name, m) for name, m in module.named_modules()
                      if isinstance(m, SIGEModule)]
        self._gathers = [(tuple(name.split(".")), m) for name, m in self._sige
                         if isinstance(m, Gather)]
        self.use(self.new_state())

    # --- sessions ---------------------------------------------------------
    def new_state(self) -> EngineState:
        """An empty state: no caches, no plan."""
        return EngineState({name: [{} for _ in range(self.cache_slots)]
                            for name, _ in self._sige}, self.layout)

    def use(self, state: EngineState) -> None:
        """Run the following calls on ``state`` (held by reference): bind
        every SIGE layer's ``cache`` to its slot-0 dict there and hand
        every Gather its entry of the state's plan."""
        self.state = state
        self._bind(0)
        for path, g in self._gathers:
            if state.plan_host is None:
                g.plan, g.plan_host = {}, {}
            else:
                g.plan_host = _get_path(state.plan_host, path)
                g.plan = _get_path(state.plan, path)

    def _bind(self, slot: int) -> None:
        """Every SIGE layer's ``cache``: its dict of ``slot`` in the
        current state."""
        if not 0 <= slot < self.cache_slots:
            raise IndexError(f"cache_id {slot} outside the model's "
                             f"{self.cache_slots} slots")
        caches = self.state.caches
        for name, m in self._sige:
            # a plain attribute: bypass nn.Module's registry checks
            object.__setattr__(m, "cache", caches[name][slot])

    @property
    def plan(self) -> Dict:
        return self.state.plan

    @property
    def plan_host(self) -> Optional[Dict]:
        return self.state.plan_host

    @property
    def active_layout(self) -> str:
        return self.state.active_layout

    # --- parameters and forwards -------------------------------------------
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

    def _run(self, args, kwargs, ctx: SIGECtx):
        """The module on ``args`` over slot ``ctx.cache_id`` of the
        current state."""
        self._bind(ctx.cache_id)
        return self.module(*args, ctx=ctx, **kwargs)

    @torch.inference_mode()
    @fp32_scope()
    def full(self, *args, cache_id: int = 0, **kwargs):
        """Dense pass on the original input: refreshes every scatter cache
        of slot ``cache_id`` and the planning metadata. A new input shape
        drops the stale plan and pins."""
        sig = tuple(tuple(a.shape) if hasattr(a, "shape") else a
                    for a in args)
        if sig != self._input_sig:
            if self._input_sig is not None:
                self.state.plan, self.state.plan_host = {}, None
                self.state.pins = {}
            self._input_sig = sig
            self.meta = None
        y = self._run(args, kwargs, SIGECtx(mode="full", cache_id=cache_id,
                                            cache_dtype=self.cache_dtype))
        if self.meta is None:
            self.meta = self._gathers_meta()
        return y

    def set_masks(self, masks: Mapping, capacities: Optional[Dict] = None):
        """Host-side planning: mask pyramid -> indices/source maps or
        windows, moved to the device and handed to every Gather.
        ``capacities`` pins buffer and box shapes (see
        :func:`~.planner.plan_pins` and :func:`~.planner.merge_pins`);
        without it, the session's own pins (:meth:`pin_capacities`)."""
        if self.meta is None:
            raise RuntimeError("run a full() pass before set_masks()")
        layout = self.layout
        if layout == "auto":
            layout = choose_layout(masks)
        plan = build_plan(self.meta, masks, self.bucket_min,
                          capacities or self.state.pins, layout=layout,
                          chain_nesting=self.chain_nesting)
        state = self.state
        state.active_layout = layout
        state.plan_host, state.plan = plan, upload_plan(plan, self.device)
        self.use(state)
        return plan

    def pin_capacities(self) -> Dict:
        """Freeze every tile buffer's capacity and bbox-cropped source-map
        shape of the current plan in the current session, so later
        ``set_masks`` calls with smaller edits plan exactly these shapes
        (the same conv shapes, so no new cuDNN timing; fixed shapes for
        plans stacked across sessions). Returns the pin map; call after
        planning the largest expected edit. Tile layout only: window
        layouts bucket their own extents. A new input shape in ``full``
        drops the pins."""
        if self.plan_host is None:
            raise RuntimeError("call set_masks() before pin_capacities()")
        self.state.pins.update(plan_pins(self.plan_host))
        return dict(self.state.pins)

    @torch.inference_mode()
    @fp32_scope()
    def sparse(self, *args, cache_id: int = 0, sparse_update: bool = False,
               **kwargs):
        """Sparse inference on the edited input over slot ``cache_id``;
        ``sparse_update`` writes the scattered maps into the slot (the
        edit becomes the slot's baseline; the models' window chains step
        aside for it, since a chain never forms the scattered maps)."""
        if not self.plan:
            raise RuntimeError("call set_masks() before sparse()")
        return self._run(args, kwargs, SIGECtx(
            mode="sparse", cache_id=cache_id, sparse_update=sparse_update,
            cache_dtype=self.cache_dtype))

    @torch.inference_mode()
    @fp32_scope()
    def dense(self, *args, **kwargs):
        """Plain dense inference (the baseline), no caching."""
        return self.module(*args, ctx=SIGECtx(mode="dense"), **kwargs)

    def clear_cache(self) -> None:
        """Empty every slot of the current state."""
        for slots in self.state.caches.values():
            for d in slots:
                d.clear()

    def stats(self) -> Dict[str, Any]:
        """Per-gather sparsity statistics for the current plan."""
        if self.meta is None or self.plan_host is None:
            return {}
        return plan_stats(self.meta, self.plan_host)
