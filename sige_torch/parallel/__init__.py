"""Serving: ``TwinStepServer`` (B requests sharing one plan, batched twin
steps), ``SessionServer`` (S editing sessions, each with its own plan, as
one batched forward), ``PlanStack`` (the per-session plans stacked on
shared shape pins) and ``upload_reuse``: ports of
``sige_tpu.parallel.serving``; and the (dp, tp) mesh both servers take
(``make_mesh``, ``replicate``, ``shard_batch``, ``shard_cache``,
``gather_batch``): the port of ``sige_tpu.parallel.mesh`` over
``torch.distributed`` ranks, one process per card. ``parallel/spatial.py``
(rows of one request sharded over cards) is not ported yet."""

from .mesh import (Mesh, gather_batch, make_mesh, replicate, shard_batch,
                   shard_cache)
from .serving import PlanStack, SessionServer, TwinStepServer, upload_reuse

__all__ = ["Mesh", "PlanStack", "SessionServer", "TwinStepServer",
           "gather_batch", "make_mesh", "replicate", "shard_batch",
           "shard_cache", "upload_reuse"]
