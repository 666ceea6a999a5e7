"""Serving on one GPU: ``TwinStepServer`` (B requests sharing one plan,
batched twin steps), ``SessionServer`` (S editing sessions, each with its
own plan, as one batched forward), ``PlanStack`` (the per-session plans
stacked on shared shape pins) and ``upload_reuse``: ports of
``sige_tpu.parallel.serving``; the mesh modules are multi-card and not
ported."""

from .serving import PlanStack, SessionServer, TwinStepServer, upload_reuse

__all__ = ["PlanStack", "SessionServer", "TwinStepServer", "upload_reuse"]
