"""Serving on one GPU: ``TwinStepServer`` (B requests sharing one plan,
batched twin steps) and ``SessionServer`` (S editing sessions, each with
its own plan): ports of ``sige_tpu.parallel.serving``'s classes; the
mesh modules are multi-card and not ported."""

from .serving import SessionServer, TwinStepServer

__all__ = ["SessionServer", "TwinStepServer"]
