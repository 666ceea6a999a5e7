"""Serving on one GPU: batched twin steps for B requests that share one
plan (``TwinStepServer``), and S concurrent editing sessions, each with
its OWN mask and plan (``SessionServer``) — the ports of
``sige_tpu.parallel.serving``'s classes of those names, without a mesh.

``TwinStepServer`` is the identical-mask batching regime (inpainting
with a fixed template, per-mask request queues): one step runs the full
pass on the B originals, refreshing their caches, then the sparse pass
on the B edits, each one batched forward over the shared plan.

``sige_tpu`` makes sessions a batch axis: per-session plans stack on a
leading axis with shared shape pins (``PlanStack``, ``upload_reuse``) so
ONE vmapped program runs every session, dp-sharded over a mesh. Here the
sessions are a loop: each holds an
:class:`~sige_torch.nn.engine.EngineState` (its caches and its own
plan), and a step switches the engine to each state by reference and
runs its sparse forward. Plans need no common shapes, so nothing is
pinned; one batched forward over the sessions comes with a later slice
(ROADMAP Queue 2).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import torch
from torch import nn

from ..nn.engine import EngineState, SIGEModel
from ..nn.planner import plan_layout


class TwinStepServer:
    """B edit requests that share one plan, on one model. ``params`` is a
    state dict for ``module`` (None keeps its weights); ``plan`` is a host
    plan as :meth:`SIGEModel.set_masks` returns it (built from a full pass
    on one request: plans carry no batch axis). :meth:`prime` fills the
    caches of the B originals; :meth:`step` runs a twin step. The device
    is the GPU unless ``device="cpu"``."""

    def __init__(self, module: nn.Module,
                 params: Optional[Mapping[str, torch.Tensor]],
                 plan: Mapping, device=None):
        if params is not None:
            module.load_state_dict(params)
        self.model = SIGEModel(module, device=device)
        self.plan = plan
        self.layout = plan_layout(plan)

    def _full(self, x, args):
        """The full pass on the originals, with the shared plan installed
        after it: a new input shape makes ``full`` drop the state's plan."""
        y = self.model.full(x, *args)
        if not self.model.plan:
            self.model.set_plan(self.plan, self.layout)
        return y

    def prime(self, x_batch, *args):
        """One full pass on the original batch ([B, ...]; extra model args
        lead with B too): fills the caches and installs the plan. Returns
        the planning metadata, as ``sige_tpu``'s does."""
        self._full(x_batch, args)
        return self.model.meta

    def step(self, x_orig, x_edit, *args):
        """One twin step: the full pass on the originals (refreshing their
        caches), then the sparse pass on the edits under the shared plan.
        Returns (y0, y1), each [B, ...]."""
        if self.model.meta is None:
            raise RuntimeError("prime() before step()")
        y0 = self._full(x_orig, args)
        return y0, self.model.sparse(x_edit, *args)


class SessionServer:
    """S editing sessions on one model. ``layout="window"`` (the default,
    as in ``sige_tpu``) rides the window-resident chains per session;
    pass ``layout="tiles"`` for scattered multi-region edits. ``params``
    is a state dict for ``module`` (None keeps its weights)."""

    def __init__(self, module: nn.Module,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 bucket_min: int = 2, layout: str = "window", device=None):
        if params is not None:
            module.load_state_dict(params)
        self.model = SIGEModel(module, bucket_min=bucket_min, layout=layout,
                               device=device)
        self.states: List[EngineState] = []

    @property
    def num_sessions(self) -> int:
        return len(self.states)

    def prime(self, x_sessions, *args) -> None:
        """One full pass per session on its original input ([S, B, ...];
        extra model args lead with S too): fills each session's caches
        and records the planning metadata."""
        model = self.model
        self.states = []
        for s in range(x_sessions.shape[0]):
            model.use(model.new_state())
            model.full(x_sessions[s], *(a[s] for a in args))
            self.states.append(model.state)

    def set_masks(self, i: int, masks) -> None:
        """Host planning for session ``i``'s edit mask pyramid."""
        if not self.states:
            raise RuntimeError("prime() before set_masks()")
        self.model.use(self.states[i])
        self.model.set_masks(masks)

    def step(self, x_edit, *args, sparse_update: bool = False):
        """One sparse step for every session ([S, B, ...] in and out).
        ``sparse_update=True`` commits the edits into the caches (the
        demo's "apply")."""
        model, ys = self.model, []
        for s, state in enumerate(self.states):
            model.use(state)
            ys.append(model.sparse(x_edit[s], *(a[s] for a in args),
                                   sparse_update=sparse_update))
        return torch.stack(ys)
