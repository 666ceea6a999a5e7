"""Serving: batched twin steps for B requests that share one plan
(``TwinStepServer``), and S concurrent editing sessions, each with its
OWN mask and plan, run as one batch (``SessionServer``, over the
per-session plans that ``PlanStack`` stacks on shared shape pins) — the
ports of ``sige_tpu.parallel.serving``'s classes of those names.

Both take a (dp, tp) ``mesh`` (:mod:`sige_torch.parallel.mesh`: one
process per card, the same global arguments on every rank). Each rank
runs its dp rows (B/dp requests, S/dp sessions) and returns them;
``gather_batch`` assembles the global batch after a step. Without a
process group the mesh is one rank and a server runs everything on its
card.

``TwinStepServer`` is the identical-mask batching regime (inpainting
with a fixed template, per-mask request queues): one step runs the full
pass on the B originals, refreshing their caches, then the sparse pass
on the B edits, each one batched forward over the shared plan.

``SessionServer`` is the multi-user regime. ``sige_tpu`` makes the
sessions a ``vmap`` axis; here they are the batch axis: S sessions of B
samples run as one forward at batch S*B, sample ``s*B + b`` under
session s's plan. The per-session plans stack on a leading session axis
because their leaf shapes are pinned to be equal (``PlanStack``); the
window origins, box origins and masks that differ between sessions are
device data that the ops read per sample (``sige_torch/ops/sessions.py``,
on which every op of ``ops/window.py``, ``ops/gather.py`` and
``ops/scatter.py`` is built: the engine installs every plan with a
leading session axis, one session's as a stack of one). The stacked
plan stays resident (``ResidentPlan``): after an edit only that
session's row is written, on the host and in a pinned staging buffer,
and the whole plan moves to the card in one copy.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..nn.engine import SIGEModel, pack_offsets, packed_view
from ..nn.planner import (build_plan, get_path, merge_pins, plan_layout,
                          plan_leaves, plan_pins, plan_rows, set_path,
                          stack_plans)
from ..utils import trace
from .mesh import Mesh, make_mesh, replicate, shard_batch


def _same_device(a, b) -> bool:
    """Whether two device names are one device, a CUDA device without an
    index read as the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


def _on_mesh(module: nn.Module, params, mesh: Optional[Mesh], tp: int,
             device) -> Mesh:
    """A server's mesh (``mesh``, else the (dp, tp) mesh of the world:
    one rank without a process group, on ``device``), with ``params``
    loaded into ``module``: rank 0's on a mesh of several ranks, where a
    rank without ``params`` takes rank 0's weights."""
    if mesh is None:
        mesh = make_mesh(tp=tp, device=device)
    elif device is not None and not _same_device(device, mesh.device):
        raise ValueError(f"device {device} beside a mesh on {mesh.device}")
    if params is not None or mesh.size > 1:
        module.load_state_dict(replicate(
            mesh, module.state_dict() if params is None else params))
    return mesh


class TwinStepServer:
    """B edit requests that share one plan, on one model. ``params`` is a
    state dict for ``module`` (None keeps its weights; on a mesh, rank 0's
    are broadcast); ``plan`` is a host plan as :meth:`SIGEModel.set_masks`
    returns it (built from a full pass on one request: plans carry no
    batch axis). :meth:`prime` fills the caches of the B originals;
    :meth:`step` runs a twin step. On a (dp, tp) ``mesh`` (default: the
    world's, with ``tp``) every rank takes the same global batch and runs
    its B/dp requests. The device is the mesh's: the GPU unless
    ``device="cpu"``."""

    def __init__(self, module: nn.Module,
                 params: Optional[Mapping[str, torch.Tensor]],
                 plan: Mapping, device=None, mesh: Optional[Mesh] = None,
                 tp: int = 1):
        self.mesh = _on_mesh(module, params, mesh, tp, device)
        self.model = SIGEModel(module, device=self.mesh.device)
        self.plan = plan
        self.layout = plan_layout(plan)

    def _full(self, x, args):
        """The full pass on the originals, with the shared plan installed
        after it: a new input shape makes ``full`` drop the state's plan."""
        y = self.model.full(x, *args)
        if not self.model.plan:
            self.model.set_plan(stack_plans([self.plan]), self.layout)
        return y

    def _rows(self, *xs):
        return [shard_batch(self.mesh, x) for x in xs]

    def prime(self, x_batch, *args):
        """One full pass on the original batch ([B, ...]; extra model args
        lead with B too; on a mesh, this rank's rows of them): fills the
        caches and installs the plan. Returns the planning metadata, as
        ``sige_tpu``'s does."""
        x, *args = self._rows(x_batch, *args)
        self._full(x, args)
        return self.model.meta

    def step(self, x_orig, x_edit, *args):
        """One twin step: the full pass on the originals (refreshing their
        caches), then the sparse pass on the edits under the shared plan.
        Returns (y0, y1), this rank's rows of each ([B/dp, ...]; all B on
        one rank)."""
        if self.model.meta is None:
            raise RuntimeError("prime() before step()")
        x0, x1, *args = self._rows(x_orig, x_edit, *args)
        y0 = self._full(x0, args)
        return y0, self.model.sparse(x1, *args)


class PlanStack:
    """Per-session host plans with shared shape pins, stacked on a
    leading session axis (the port of ``sige_tpu.parallel.PlanStack``).

    Pinned tile capacities AND pinned box/window shapes
    (:func:`~sige_torch.nn.planner.plan_pins` + ``__winext__`` extent
    pins) keep every plan leaf's shape identical across sessions, so S
    independent edit plans stack into one tree that one batched sparse
    forward consumes. A session whose edit outgrows the pins triggers a
    re-pin to the merged maximum and one rebuild of the plans that no
    longer conform.

    ``layout="window"`` stacks window-layout plans: window ORIGINS are
    per-session data, only the bucketed EXTENTS are shared shapes —
    pinned to the across-session maximum per resolution, and the windowed
    resolution set to the across-session intersection (a session whose
    edit is too spread for a window at some resolution forces everyone to
    tiles there; the hybrid fallback keeps chains breaking cleanly at the
    seam). ``win_pins`` is that set with its extents once merged; ``{}``
    means tiles everywhere.

    Window metas start in the fast 2-form (every session's windows in
    image, the common case); the first cross-session form mismatch (a
    border edit meets an interior one) flips ``meta_fast`` off and
    rebuilds every plan in the 4-form.

    ``stacked()`` returns the resident stacked tree, whose values always
    equal ``stack_plans(self.plans)``. When every session set since the
    last call has a plan of the tree's layout (its leaf paths, and each
    leaf's per-session shape and dtype), only those sessions' rows are
    written, in place, and ``row_versions[i]`` counts each write of row
    i; otherwise (the first call, a re-pin, the switch to the 4-form)
    the tree is built anew, a new object."""

    def __init__(self, meta_host, num_sessions: int, bucket_min: int = 2,
                 layout: str = "tiles", chain_nesting: bool = True):
        self.meta = meta_host
        self.bucket_min = bucket_min
        self.layout = layout
        self.chain_nesting = chain_nesting if layout == "window" else False
        self.masks = [None] * num_sessions
        self.plans = [None] * num_sessions
        # {res: (r0, c0, WH, WW)} per session
        self.windows = [None] * num_sessions
        self.pins = {}
        self.win_pins = None  # {res: (WH, WW)} once first merged
        self.meta_fast = True
        self._stacked = None
        self._dirty = set()  # sessions set since the tree last took them
        self.row_versions = [0] * num_sessions

    def _caps(self):
        caps = dict(self.pins)
        if self.win_pins is not None:  # {} is meaningful: tiles everywhere
            caps[("__winext__",)] = dict(self.win_pins)
        caps[("__metafast__",)] = self.meta_fast
        return caps

    def _build(self, masks, i=None):
        trace.counters["plans_built"] += 1
        wins = {}
        plan = build_plan(self.meta, masks, self.bucket_min, self._caps(),
                          layout=self.layout,
                          chain_nesting=self.chain_nesting,
                          out_windows=wins)
        if i is not None:
            self.windows[i] = wins
        return plan

    def _repin(self) -> None:
        """Merge pins across all sessions' built plans and re-enforce.
        Only sessions whose plan does NOT already conform to the merged
        pins are rebuilt."""
        self.pins = merge_pins(*(plan_pins(p) for p in self.plans))
        if self.layout == "window":
            live = [w for w in self.windows if w is not None]
            common = set(live[0])
            for w in live[1:]:
                common &= set(w)
            self.win_pins = {
                res: (max(w[res][2] for w in live),
                      max(w[res][3] for w in live))
                for res in common}
        for i, m in enumerate(self.masks):
            if not self._conforms(i):
                self.plans[i] = self._build(m, i)

    def _conforms(self, i: int) -> bool:
        """True when session ``i``'s built plan already has exactly the
        merged pins' leaf shapes (and the pinned windowed-resolution set),
        so rebuilding it could not change any shape."""
        if plan_pins(self.plans[i]) != self.pins:
            return False
        if self.layout == "window" and self.win_pins is not None:
            w = self.windows[i]
            if set(w) != set(self.win_pins):
                return False
            return all((w[r][2], w[r][3]) == tuple(self.win_pins[r])
                       for r in w)
        return True

    def set(self, i: int, masks) -> None:
        trace.counters["edits"] += 1
        self.masks[i] = masks
        self.plans[i] = self._build(masks, i)
        self._dirty.add(i)

    def set_if_changed(self, i: int, masks) -> bool:
        """set(), skipped (returning False) when session ``i``'s mask
        pyramid is unchanged: planning and the stacked rows are pure
        functions of the masks."""
        old = self.masks[i]
        if (old is not None and set(old) == set(masks)
                and all(np.array_equal(old[k], masks[k]) for k in masks)):
            return False
        self.set(i, masks)
        return True

    def _write_row(self, i: int) -> bool:
        """Write session ``i``'s plan into row i of the resident tree, in
        place; False, with the row part written, when the plan does not
        have the tree's layout."""

        def walk(node, ref) -> bool:
            if not isinstance(node, Mapping) or node.keys() != ref.keys():
                return False
            for k, r in ref.items():
                if isinstance(r, dict):
                    if not walk(node[k], r):
                        return False
                    continue
                a = np.asarray(node[k])
                if a.shape != r.shape[1:] or (a.dtype is not r.dtype
                                              and a.dtype != r.dtype):
                    return False
                r[i] = a
            return True

        return walk(self.plans[i], self._stacked)

    def stacked(self):
        if self._stacked is not None and not self._dirty:
            return self._stacked
        with trace.span("sige.serving.stack"):
            missing = [i for i, p in enumerate(self.plans) if p is None]
            if missing:
                raise RuntimeError(f"set_masks() missing for sessions "
                                   f"{missing}")
            # a row that does not fit is left part written: the full
            # restack below replaces the tree
            if self._stacked is not None and all(
                    self._write_row(i) for i in sorted(self._dirty)):
                for i in self._dirty:
                    self.row_versions[i] += 1
                self._dirty.clear()
                return self._stacked
            # pin -> rebuild iterates: enforcing a merged window extent can
            # re-grow a NESTED coarser window past ITS pin (border clamping
            # differs per session), re-drifting shapes. Extents only grow and
            # are canvas-capped, so this terminates — 2 rounds in practice.
            for _ in range(16):
                try:
                    self._stacked = stack_plans(self.plans)
                    self._dirty.clear()
                    return self._stacked
                except ValueError:
                    if self.meta_fast and self._meta_form_mismatch():
                        # a border edit met interior ones: the uniform 4-form
                        # for every session (re-pinning cannot fix a form)
                        self.meta_fast = False
                        self.plans = [self._build(m, i)
                                      for i, m in enumerate(self.masks)]
                    else:
                        self._repin()
            raise RuntimeError("plan stacking failed to converge on shared "
                               "shape pins (window nesting did not settle)")

    def _meta_form_mismatch(self) -> bool:
        """True when any window-meta leaf ships in the fast 2-form in one
        session and the 4-form in another (ops/window.py _fast) — the one
        leaf-shape drift a capacity/extent re-pin cannot reconcile."""
        forms = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, Mapping):
                    walk(v, path + (k,))
                elif (k in ("win_in", "wdnp_in")
                      or k.startswith("wsg_in_")):
                    forms.setdefault(path + (k,), set()).add(
                        np.asarray(v).shape)

        for p in self.plans:
            walk(p, ())
        return any(len(s) > 1 for s in forms.values())


class ResidentPlan:
    """``rows`` of a :class:`PlanStack`'s stacked plan, resident on
    ``device``: the host tree (views of the stack's resident tree), a
    staging buffer of its leaves in :func:`~sige_torch.nn.engine.
    upload_leaves`' packing (pinned on a CUDA device) and one device
    buffer of the same bytes, whose views are the device tree. The device
    holds byte for byte what ``upload_plan`` of the host tree would give.

    :meth:`update` builds all three anew when the stack's tree is a new
    object (a new layout). When the stack wrote rows in place, it writes
    those of them in ``rows`` into the staging buffer and copies the
    whole buffer to the device buffer, in place: one copy on the current
    stream, after the kernels that read the plan before it. Before the
    next write into the staging buffer it waits on the event recorded
    after that copy."""

    def __init__(self, device, rows: slice):
        self.device = torch.device(device)
        self.rows = rows
        self.host: Optional[Dict] = None
        self.tree: Optional[Dict] = None
        self.buf: Optional[torch.Tensor] = None
        self._source = None  # the stack's tree the layout was built from
        self._versions: List[int] = []
        self._staged = []  # (staging view [rows, ...], the stack's leaf)
        self._staging: Optional[torch.Tensor] = None
        self._copied = (torch.cuda.Event() if self.device.type == "cuda"
                        else None)

    def _copy(self) -> None:
        self.buf.copy_(self._staging, non_blocking=True)
        if self._copied is not None:
            self._copied.record(torch.cuda.current_stream(self.device))

    def _build(self, stacked: Mapping) -> None:
        self.host = plan_rows(stacked, self.rows)
        leaves = plan_leaves(self.host)
        offsets, size = pack_offsets([a for _, a in leaves])
        self._staging = torch.zeros(size, dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda")
        staging, self._staged = self._staging.numpy(), []
        for (path, a), o in zip(leaves, offsets):
            view = packed_view(staging, a, o)
            view[...] = a
            self._staged.append((view, get_path(stacked, path)))
        self.buf = torch.empty(size, dtype=torch.uint8, device=self.device)
        self._copy()
        self.tree = {}
        for (path, a), o in zip(leaves, offsets):
            set_path(self.tree, path, packed_view(self.buf, a, o))
        self._source = stacked

    def update(self, stack: PlanStack) -> bool:
        """Bring the device up to date with ``stack.stacked()``. True when
        the layout was built anew (:attr:`host` and :attr:`tree` are new
        objects), False when rows moved in place or nothing changed."""
        stacked = stack.stacked()
        if stacked is not self._source:
            with trace.span("sige.serving.upload"):
                self._build(stacked)
            self._versions = list(stack.row_versions)
            trace.counters["plan_full_installs"] += 1
            return True
        moved = [i for i, (v, w) in enumerate(zip(stack.row_versions,
                                                  self._versions)) if v != w]
        if not moved:
            return False
        self._versions = list(stack.row_versions)
        trace.counters["plan_row_installs"] += 1
        start, stop, _ = self.rows.indices(len(self._versions))
        mine = [i for i in moved if start <= i < stop]
        if mine:
            with trace.span("sige.serving.upload"):
                if self._copied is not None:
                    self._copied.synchronize()
                for view, leaf in self._staged:
                    for i in mine:
                        view[i - start] = leaf[i]
                self._copy()
        return False


def _flat(t):
    """[S, B, ...] -> [S*B, ...]: the sessions side by side in one batch."""
    return t.flatten(0, 1)


class SessionServer:
    """S editing sessions on one model, each with its OWN mask — the
    multi-user regime. Sessions are a batch axis: :meth:`prime` runs ONE
    full pass over the S sessions' originals, the per-session plans stack
    on shared shape pins (:class:`PlanStack`), and :meth:`step` runs ONE
    sparse forward over every session's caches and plan.

    ``layout="window"`` (the default, as in ``sige_tpu``) rides the
    window-resident chains per session, extents pinned to the
    across-session maximum; pass ``layout="tiles"`` for scattered
    multi-region edits. ``params`` is a state dict for ``module`` (None
    keeps its weights; on a mesh, rank 0's are broadcast).

    On a (dp, tp) ``mesh`` (default: the world's, with ``tp``) every rank
    takes the same global arguments and runs S/dp sessions: it plans all
    S (planning is deterministic, and the pins are shared across all S),
    installs its rows of the stacked plan and returns its rows of the
    step, equal to the one-process server's rows with no collective. The
    device is the mesh's: the GPU unless ``device="cpu"``.

    Every family runs stacked in both layouts: the DDPM, PD and SD U-Nets,
    the SD VAE and the GauGAN generators. The SD models' masked
    stale/fresh attention (window layout) takes one key bias row per
    session (``ops/attention.py stale_fresh_biases``)."""

    def __init__(self, module: nn.Module,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 bucket_min: int = 2, layout: str = "window", device=None,
                 mesh: Optional[Mesh] = None, tp: int = 1):
        if layout not in ("tiles", "window"):
            raise ValueError(f"unknown layout {layout!r}")
        self.mesh = _on_mesh(module, params, mesh, tp, device)
        self.model = SIGEModel(module, bucket_min=bucket_min, layout=layout,
                               device=self.mesh.device)
        self.bucket_min = bucket_min
        self.layout = layout
        self.num_sessions: Optional[int] = None
        self._stack: Optional[PlanStack] = None
        self._plan: Optional[ResidentPlan] = None

    def _rows(self, x):
        """This rank's sessions of an [S, ...] argument, flattened to
        [S/dp * B, ...]."""
        return _flat(shard_batch(self.mesh, x))

    def prime(self, x_sessions, *args) -> None:
        """One full pass over the sessions' original inputs ([S, B, ...];
        extra model args lead with S too; on a mesh, this rank's S/dp
        sessions) at batch S/dp * B: fills the caches and records the
        planning metadata."""
        S = int(x_sessions.shape[0])
        if S % self.mesh.dp:
            raise ValueError(f"{S} sessions over dp={self.mesh.dp}")
        self.num_sessions = S
        self.model.full(self._rows(x_sessions),
                        *(self._rows(a) for a in args))
        self._stack = PlanStack(self.model.meta, S, self.bucket_min,
                                layout=self.layout,
                                chain_nesting=self.model.chain_nesting)
        self._plan = ResidentPlan(self.model.device, self.mesh.rows(S))

    def set_masks(self, i: int, masks) -> None:
        """Host planning for session ``i``'s edit mask pyramid."""
        if self._stack is None:
            raise RuntimeError("prime() before set_masks()")
        with trace.span("sige.serving.set_masks"):
            self._stack.set(i, masks)

    def _install(self) -> None:
        """This rank's rows of the stacked plan on the card and in the
        model (:class:`ResidentPlan`): the model takes the trees again only
        when their layout was built anew; rows written in place reach the
        Gathers through the same tensors."""
        with trace.span("sige.serving.install"):
            plan = self._plan
            if plan.update(self._stack) or self.model.plan is not plan.tree:
                self.model.set_plan(plan.host, plan_layout(plan.host),
                                    device_plan=plan.tree)

    def step(self, x_edit, *args, sparse_update: bool = False):
        """One sparse forward over the sessions ([S, B, ...] in; out this
        rank's [S/dp, B, ...], all S on one rank). ``sparse_update=True``
        commits every session's edit into the caches (the demo's
        "apply")."""
        if self._stack is None:
            raise RuntimeError("prime() before step()")
        with trace.span("sige.serving.step"):
            self._install()
            y = self.model.sparse(self._rows(x_edit),
                                  *(self._rows(a) for a in args),
                                  sparse_update=sparse_update)
            return y.unflatten(0, (self.num_sessions // self.mesh.dp, -1))
