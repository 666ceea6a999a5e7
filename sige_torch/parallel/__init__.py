"""Serving: ``TwinStepServer`` (B requests sharing one plan, batched twin
steps), ``SessionServer`` (S editing sessions, each with its own plan, as
one batched forward) and ``PlanStack`` (the per-session plans stacked on
shared shape pins): ports of ``sige_tpu.parallel.serving``, beside
``ResidentPlan`` (the stacked plan kept on the card, moved row by row
after an edit); and the (dp, tp) mesh both servers take
(``make_mesh``, ``replicate``, ``shard_batch``, ``shard_cache``,
``gather_batch``): the port of ``sige_tpu.parallel.mesh`` over
``torch.distributed`` ranks, one process per card; and spatial
parallelism (``make_spatial_mesh``, ``row_sharding``, ``spatial_apply``,
``spatial_full_apply``, ``gather_rows``, ``gather_caches``): the port of
``sige_tpu.parallel.spatial``, the rows of one big request over ranks."""

from .mesh import (Mesh, gather_batch, make_mesh, replicate, shard_batch,
                   shard_cache)
from .serving import PlanStack, ResidentPlan, SessionServer, TwinStepServer
from .spatial import (BandCaches, RowBand, SpatialMesh, gather_caches,
                      gather_rows, make_spatial_mesh, row_sharding,
                      spatial_apply, spatial_full_apply)

__all__ = ["BandCaches", "Mesh", "PlanStack", "ResidentPlan", "RowBand",
           "SessionServer", "SpatialMesh", "TwinStepServer", "gather_batch",
           "gather_caches", "gather_rows", "make_mesh", "make_spatial_mesh",
           "replicate", "row_sharding", "shard_batch", "shard_cache",
           "spatial_apply", "spatial_full_apply"]
