"""Per-session serving on one GPU: S concurrent editing sessions, each
with its OWN mask and plan — the multi-user interactive-editing regime
(the port of ``sige_tpu.parallel.serving.SessionServer``).

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
