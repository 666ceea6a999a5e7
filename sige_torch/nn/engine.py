"""Stateful wrapper around a SIGE-wired torch module.

Mirrors the reference's whole-model API — ``set_mode`` is implicit in
which method you call, plus ``set_masks`` / ``clear_cache``
(reference: sige/nn/base.py:95-129) — and the methods of
``sige_tpu.nn.engine.SIGEModel``: :meth:`full` and :meth:`sparse` run the
module eagerly under ``torch.inference_mode``, on cache slot
``cache_id`` (``sparse_update`` commits an edit into its slot);
:meth:`adopt_full` installs the caches and metadata of a full pass run
elsewhere; :meth:`set_masks` plans on the host (:meth:`plan_masks`) and moves the
plan's leaves to the device in one copy (:meth:`set_plan`);
:meth:`SIGEModel.pin_capacities` freezes the current plan's tile-layout
shapes for later edits. An :class:`EngineState` holds one session's
caches, plan and pins; :meth:`SIGEModel.use` switches sessions by
reference. ``cache_dtype`` narrows the storage of the scatter caches
(see :class:`~.module.SIGECtx`).

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
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import trace
from .module import Gather, SIGECtx, SIGEModule
from .planner import (build_plan, choose_layout, get_path, plan_leaves,
                      plan_pins, plan_rows, plan_stats, set_path,
                      stack_plans)


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
    trace.engine_scopes += 1
    try:
        yield
    finally:
        trace.engine_scopes -= 1
        set_precision_flags(saved)


def pack_offsets(arrays: List[np.ndarray]) -> Tuple[List[int], int]:
    """Each array's byte offset in the packing of :func:`upload_leaves`
    (int arrays as int64, bool arrays, the window coverage and edge
    masks, as one byte an element; each at an 8-byte offset), and the
    packed buffer's bytes."""
    offsets, pos = [], 0
    for a in arrays:
        offsets.append(pos)
        n = a.size * (1 if a.dtype == np.bool_ else 8)
        pos += n + (-n % 8)
    return offsets, pos


def packed_view(buf, a: np.ndarray, offset: int):
    """The view of a packed byte buffer (a uint8 numpy array or tensor)
    that holds ``a`` at ``offset``: int64, or bool, in ``a``'s shape."""
    n = a.size * (1 if a.dtype == np.bool_ else 8)
    part = buf[offset:offset + n]
    if isinstance(part, np.ndarray):
        return part.view(np.bool_ if a.dtype == np.bool_ else np.int64
                         ).reshape(a.shape)
    return part.view(torch.bool if a.dtype == np.bool_ else torch.int64
                     ).view(a.shape)


def upload_leaves(arrays: List[np.ndarray], device: torch.device
                  ) -> List[torch.Tensor]:
    """The arrays as tensors on ``device``, moved in ONE copy: packed into
    one byte buffer (:func:`pack_offsets`, the padding zero) and split
    into views of it on the device."""
    offsets, size = pack_offsets(arrays)
    host = np.zeros(size, np.uint8)
    for a, o in zip(arrays, offsets):
        packed_view(host, a, o)[...] = a
    buf = torch.from_numpy(host).to(device)
    return [packed_view(buf, a, o) for a, o in zip(arrays, offsets)]


def upload_plan(plan: Mapping, device: torch.device) -> Dict:
    """The plan tree with every leaf a tensor on ``device``, moved in ONE
    copy (:func:`upload_leaves`)."""
    leaves = plan_leaves(plan)
    out: Dict = {}
    for (path, _), t in zip(leaves, upload_leaves([a for _, a in leaves],
                                                  device)):
        set_path(out, path, t)
    return out


@dataclasses.dataclass
class EngineState:
    """One editing session's state in a :class:`SIGEModel`: the caches
    (for each SIGE layer, by module path, one dict per cache slot), the
    plan on the device and on the host, the layout it was built in, and
    the session's shape pins (:meth:`SIGEModel.pin_capacities`: kept per
    session, so one session's pins never shape another's plan).
    :meth:`SIGEModel.use` switches the model to a state by reference: no
    cache tensor is copied.

    The installed plan, on the host and on the device, always leads with
    S >= 1: every leaf of ``plan`` and ``plan_host`` has a leading session
    axis (:func:`~.planner.stack_plans`; one session's plan is a stack of
    one), and a forward at batch S*B runs sample s*B + b under row s."""

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
        every Gather its entry of the state's device plan."""
        self.state = state
        self._bind(0)
        for path, g in self._gathers:
            g.plan = get_path(state.plan, path) if state.plan else {}

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
                set_path(meta, path, g.meta)
        return meta

    def _run(self, args, kwargs, ctx: SIGECtx):
        """The module on ``args`` over slot ``ctx.cache_id`` of the
        current state."""
        self._bind(ctx.cache_id)
        return self.module(*args, ctx=ctx, **kwargs)

    @torch.inference_mode()
    @fp32_scope()
    def full(self, *args, cache_id: int = 0, band=None, **kwargs):
        """Dense pass on the original input: refreshes every scatter cache
        of slot ``cache_id`` and the planning metadata. A new input shape
        drops the stale plan and pins. ``band``: this rank's row band
        when the input is its band of a request sharded by rows
        (``sige_torch.parallel.spatial``, which hands the caches on)."""
        sig = tuple(tuple(a.shape) if hasattr(a, "shape") else a
                    for a in args)
        if sig != self._input_sig:
            if self._input_sig is not None:
                self.state.plan, self.state.plan_host = {}, None
                self.state.pins = {}
            self._input_sig = sig
            self.meta = None
        y = self._run(args, kwargs, SIGECtx(mode="full", cache_id=cache_id,
                                            cache_dtype=self.cache_dtype,
                                            band=band))
        if self.meta is None:
            self.meta = self._gathers_meta()
        return y

    def adopt_full(self, caches: Mapping, meta: Mapping, *args):
        """Adopt the caches and planning metadata of a full pass run
        elsewhere (another :class:`SIGEModel`, another card, the CPU), as
        ``sige_tpu``'s ``SIGEModel.adopt_full`` does: ``caches`` in the
        form of :attr:`EngineState.caches` (by module path, one dict per
        slot; fewer slots than the model's leave the rest empty),
        ``meta`` as :attr:`meta` (by Gather path). The caches move onto
        :attr:`device`; every Gather gets its metadata entry (planning
        reads :attr:`meta`, the sparse pass the Gathers' own). ``args`` are
        the example inputs the external pass ran on: their shapes key the
        input signature as :meth:`full` keys it, so a later ``full`` at
        another shape drops what was adopted. The state's plan and pins
        are dropped; :meth:`set_masks` and :meth:`sparse` follow as after
        :meth:`full`."""
        paths = {name for name, _ in self._sige}
        unknown = sorted(set(caches) - paths)
        if unknown:
            raise KeyError(f"caches for modules the model lacks: {unknown}")
        state = self.state
        for name in paths:
            slots = list(caches.get(name, ()))
            if len(slots) > self.cache_slots:
                raise ValueError(f"{name}: {len(slots)} cache slots, the "
                                 f"model has {self.cache_slots}")
            slots += [{}] * (self.cache_slots - len(slots))
            state.caches[name] = [{k: t.to(self.device) for k, t in d.items()}
                                  for d in slots]
        state.plan, state.plan_host, state.pins = {}, None, {}
        for path, g in self._gathers:
            try:
                entry = get_path(meta, path)
            except KeyError:
                entry = None
            g.meta = None if entry is None else {
                k: tuple(np.asarray(a) for a in v) for k, v in entry.items()}
        self._input_sig = tuple(tuple(a.shape) if hasattr(a, "shape") else a
                                for a in args)
        self.meta = self._gathers_meta()
        self.use(state)

    def plan_masks(self, masks: Mapping, capacities: Optional[Dict] = None
                   ) -> Tuple[Dict, str]:
        """Host planning alone: (the host plan that :meth:`set_masks`
        would install for ``masks``, its layout). Nothing is uploaded and
        the state is left as it was."""
        if self.meta is None:
            raise RuntimeError("run a full() pass before set_masks()")
        layout = self.layout
        if layout == "auto":
            layout = choose_layout(masks)
        plan = build_plan(self.meta, masks, self.bucket_min,
                          capacities or self.state.pins, layout=layout,
                          chain_nesting=self.chain_nesting)
        return plan, layout

    def set_plan(self, plan: Mapping, layout: str,
                 device_plan: Optional[Mapping] = None) -> None:
        """Install a plan (built in ``layout``) in the current state and
        hand every Gather its entry. ``plan`` is the installed form, a
        stack of S sessions (:func:`~.planner.stack_plans`); the forwards
        then run S sessions of B samples as one batch of S*B, sample
        s*B + b under session s's plan. ``device_plan``: the plan already
        on the device (:class:`~sige_torch.parallel.PlanStack`); without
        it the leaves move in one copy."""
        state = self.state
        state.active_layout = layout
        if device_plan is None:
            device_plan = upload_plan(plan, self.device)
        state.plan_host, state.plan = plan, device_plan
        self.use(state)

    def set_masks(self, masks: Mapping, capacities: Optional[Dict] = None):
        """Host-side planning: mask pyramid -> indices/source maps or
        windows (:meth:`plan_masks`), installed as a stack of one
        (:meth:`set_plan`). ``capacities`` pins buffer and
        box shapes (see :func:`~.planner.plan_pins` and
        :func:`~.planner.merge_pins`); without it, the session's own pins
        (:meth:`pin_capacities`). Returns the session's host plan."""
        plan, layout = self.plan_masks(masks, capacities)
        self.set_plan(stack_plans([plan]), layout)
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
        self.state.pins.update(plan_pins(plan_rows(self.plan_host, 0)))
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
        with trace.span("sige.engine.sparse"):
            leaf = self.plan
            while isinstance(leaf, Mapping):  # S leads every leaf
                leaf = next(iter(leaf.values()))
            S = leaf.shape[0]
            if args[0].shape[0] % S:
                raise ValueError(f"batch {args[0].shape[0]} is not a "
                                 f"multiple of the plan's {S} sessions")
            return self._run(args, kwargs, SIGECtx(
                mode="sparse", cache_id=cache_id,
                sparse_update=sparse_update, cache_dtype=self.cache_dtype))

    @torch.inference_mode()
    @fp32_scope()
    def dense(self, *args, band=None, **kwargs):
        """Plain dense inference (the baseline), no caching; ``band`` as
        for :meth:`full`."""
        return self.module(*args, ctx=SIGECtx(mode="dense", band=band),
                           **kwargs)

    def clear_cache(self) -> None:
        """Empty every slot of the current state."""
        for slots in self.state.caches.values():
            for d in slots:
                d.clear()

    def stats(self) -> Dict[str, Any]:
        """Per-gather sparsity statistics for the current plan."""
        if self.meta is None or self.plan_host is None:
            return {}
        return plan_stats(self.meta, plan_rows(self.plan_host, 0))
