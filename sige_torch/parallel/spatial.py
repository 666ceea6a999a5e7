"""Spatial parallelism (sp): the rows of one big request over
``torch.distributed`` ranks, one process per card; the port of
``sige_tpu.parallel.spatial``.

``sige_tpu`` puts one sharding constraint on the input's rows and lets
XLA's SPMD partitioner insert every exchange the model needs. PyTorch has
no partitioner, so the port writes them, and every rank runs the module
on its own band of rows ``[r * H / n, (r + 1) * H / n)`` of every NHWC
map, with a :class:`RowBand` in the call's context
(``SIGECtx.band``) through which the layers reach the other ranks:

  * **halos** — a conv with a kernel taller than its stride takes ``pt``
    rows from the rank above and ``kh - s - pt`` from the rank below
    (zeros at the canvas's edges, its padding), sent point to point
    (``ops/conv.py conv2d_nhwc``);
  * **sums** — GroupNorm's statistics are two sums over the whole map,
    the mean's and then the variance's, in fp32 (``nn/norm.py``): each
    rank's partial sums are all-gathered and added in rank order, so
    every rank holds the same statistics bit for bit and caches the same
    folded affines;
  * **rows** — self-attention's K and V are all-gathered in rank order
    (tokens are row-major: that is the global token order), and the
    rank's own queries attend over them;
  * **global heights** — the planning metadata the Gathers record is at
    the global map's shapes, the same on every rank.

Every rank is called with the same global arguments and returns its band;
:func:`gather_rows` and :func:`gather_caches` assemble the global map and
caches (the counterpart of reading a JAX global array back).

**The big-canvas composition** (``sige_tpu/parallel/spatial.py:14-35``):
the one-time full pass, the step whose dense activations do not fit one
card, runs row-sharded (:func:`spatial_full_apply`: each rank keeps its
band of every cache); the caches then move to one card
(``SIGEModel.adopt_full(gather_caches(...), meta, x)``), where every
edit runs sparse with no collective on its path. The sparse step itself
never runs sharded: :class:`~sige_torch.nn.module.SIGECtx` refuses
sparse mode with a band.

Process groups come from the caller, as for :mod:`.mesh`: NCCL on
several cards (``torchrun --nproc_per_node=N``), gloo on the CPU or for
ranks sharing one card, staging CUDA tensors through the host. A world of
one (no process group) is a mesh of one: no band, and every function
equals the plain engine exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..nn.engine import SIGEModel
from .mesh import _world, all_gather_cat, rank_device, staging

COUNTS = ("halo", "all_reduce", "gather_rows", "bytes")


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A 1-D ``("sp",)`` mesh: ``size`` ranks of ``group`` (None: the
    world, or no process group on a mesh of one), this rank's ``index``,
    the device its tensors live on, and ``counts``: the collectives this
    rank ran on the mesh, by kind (``halo``, ``all_reduce``,
    ``gather_rows``) and the ``bytes`` it sent in them, which callers set
    to 0 and read."""

    size: int
    index: int
    group: Optional[dist.ProcessGroup]
    device: torch.device
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COUNTS, 0), compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"sp": self.size}

    def rows(self, h: int) -> slice:
        """This rank's rows of a map of height ``h``."""
        if h % self.size:
            raise ValueError(f"H={h} not divisible by sp={self.size}")
        k = h // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def global_rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index) if self.group \
            else index


def make_spatial_mesh(n_devices: Optional[int] = None, group=None,
                      device=None) -> SpatialMesh:
    """The ``("sp",)`` mesh of the ranks of ``group`` (the world by
    default), one rank per card: ``n_devices`` (the group's size by
    default) must be the group's size. The device is taken as
    :func:`~.mesh.make_mesh` takes it."""
    rank, world = _world(group)
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: the "
                         f"port runs one process per card")
    return SpatialMesh(n, rank, group, rank_device(rank, world, device))


def row_sharding(mesh: SpatialMesh) -> Callable[[int], slice]:
    """The counterpart of ``sige_tpu``'s row ``NamedSharding``: a map's
    height -> this rank's slice of its rows."""
    return mesh.rows


class RowBand:
    """This rank's band of rows in one sharded forward: what the layers
    call (through ``SIGECtx.band``) to reach the other ranks. Every rank
    calls the same methods in the same order, with tensors of the same
    shapes."""

    def __init__(self, mesh: SpatialMesh):
        self.mesh = mesh
        self._via = staging(mesh)
        self._rows_cached = set()

    def height(self, h: int) -> int:
        """The global height of a map whose band has ``h`` rows."""
        return h * self.mesh.size

    def _count(self, kind: str, *sent: torch.Tensor) -> None:
        self.mesh.counts[kind] += 1
        self.mesh.counts["bytes"] += sum(t.numel() * t.element_size()
                                         for t in sent)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(self._via).contiguous()

    def halo(self, x: torch.Tensor, above: int, below: int) -> torch.Tensor:
        """``x`` [B, h, W, C] with the ``above`` rows of the rank above
        before it and the ``below`` rows of the rank below after it
        (zeros beyond the canvas's first and last rows), exchanged point
        to point."""
        n, r = self.mesh.size, self.mesh.index
        B, h, W, C = x.shape
        if above > h or below > h:
            raise ValueError(f"a band of {h} rows cannot lend {above} rows "
                             f"up and {below} down: too many ranks for "
                             f"this map")
        top = torch.zeros((B, above, W, C), dtype=x.dtype, device=self._via)
        bottom = torch.zeros((B, below, W, C), dtype=x.dtype,
                             device=self._via)
        ops, sent = [], []
        peer = self.mesh.global_rank
        if above and r > 0:
            ops.append(dist.P2POp(dist.irecv, top, peer(r - 1),
                                  self.mesh.group))
        if above and r < n - 1:
            sent.append(self._staged(x[:, h - above:]))
            ops.append(dist.P2POp(dist.isend, sent[-1], peer(r + 1),
                                  self.mesh.group))
        if below and r < n - 1:
            ops.append(dist.P2POp(dist.irecv, bottom, peer(r + 1),
                                  self.mesh.group))
        if below and r > 0:
            sent.append(self._staged(x[:, :below]))
            ops.append(dist.P2POp(dist.isend, sent[-1], peer(r - 1),
                                  self.mesh.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self._count("halo", *sent)
        return torch.cat([top.to(x.device), x, bottom.to(x.device)], dim=1)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order, so every
        rank gets the same bits whatever the backend's reduction order."""
        part = self._staged(t)
        parts = [torch.empty_like(part) for _ in range(self.mesh.size)]
        dist.all_gather(parts, part, group=self.mesh.group)
        self._count("all_reduce", part)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total.to(t.device)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's band of ``t`` along axis 1 (rows of a map, or
        row-major tokens), in rank order: the global tensor."""
        return _gather(self.mesh, t, None)

    def cache_rows(self, cache: Dict, name: str) -> None:
        """Mark ``cache[name]`` (a layer's cache dict) as a band of rows;
        the caches not marked (folded affines, anything computed from
        replicated inputs) are the same on every rank."""
        self._rows_cached.add((id(cache), name))

    def rows_cached(self, cache: Dict, name: str) -> bool:
        return (id(cache), name) in self._rows_cached


class BandCaches(dict):
    """One rank's caches of a sharded full pass, in the form of
    ``EngineState.caches``; ``rows`` names the entries that are this
    rank's band of rows, as (module path, slot, name)."""

    def __init__(self, caches: Mapping, rows: FrozenSet[Tuple[str, int, str]]):
        super().__init__(caches)
        self.rows = rows


def _band_inputs(mesh: SpatialMesh, x: torch.Tensor, extra):
    """This rank's rows of ``x`` and the replicated ``extra``, on the
    mesh's device."""
    x = x[:, mesh.rows(x.shape[1])].to(mesh.device)
    return (x,) + tuple(e.to(mesh.device) if isinstance(e, torch.Tensor)
                        else e for e in extra)


def _band(mesh: SpatialMesh) -> Optional[RowBand]:
    return RowBand(mesh) if mesh.size > 1 else None


def spatial_apply(mesh: SpatialMesh, module: nn.Module, x: torch.Tensor,
                  *extra) -> torch.Tensor:
    """Run ``module`` in dense mode with the rows of ``x`` [B, H, W, C]
    (H divisible by the mesh's size) sharded over the mesh; ``extra``
    inputs (timesteps, a context) are replicated. Every rank passes the
    same global arguments and gets its band of the output's rows
    (:func:`gather_rows` assembles them). Runs through
    ``SIGEModel.dense`` (its fp32 scope and inference mode)."""
    model = SIGEModel(module, device=mesh.device)
    return model.dense(*_band_inputs(mesh, x, extra), band=_band(mesh))


def spatial_full_apply(mesh: SpatialMesh, module: nn.Module,
                       x: torch.Tensor, *extra):
    """The full-mode pass with rows sharded, as :func:`spatial_apply`:
    step 1 of the big-canvas composition. Returns ``(y_band, caches,
    meta)``: ``caches`` this rank's (a :class:`BandCaches`: its band of
    every row map, the rest whole), ``meta`` the planning metadata by
    Gather path at the global shapes, the same on every rank."""
    model = SIGEModel(module, device=mesh.device)
    band = _band(mesh)
    y = model.full(*_band_inputs(mesh, x, extra), band=band)
    caches = model.state.caches
    model.use(model.new_state())  # the module's layers let go of them
    rows = frozenset(
        (path, slot, name) for path, slots in caches.items()
        for slot, d in enumerate(slots) for name in d
        if band is not None and band.rows_cached(d, name))
    return y, BandCaches(caches, rows), model.meta


def _gather(mesh: SpatialMesh, t: torch.Tensor, dst: Optional[int]):
    """Every rank's ``t`` along axis 1 in rank order (counted as a row
    gather): on every rank (dst None) or on rank ``dst`` alone (None
    elsewhere)."""
    mesh.counts["gather_rows"] += 1
    mesh.counts["bytes"] += t.numel() * t.element_size()
    return all_gather_cat(mesh, t, 1, dst)


def gather_rows(mesh: SpatialMesh, y: torch.Tensor,
                dst: Optional[int] = None) -> Optional[torch.Tensor]:
    """The global map from every rank's band ``y`` [B, h, W, C], in rank
    order: on every rank, or with ``dst`` on that rank alone (None on the
    others). Run after a sharded forward."""
    if mesh.size == 1:
        return y
    return _gather(mesh, y, dst)


def gather_caches(mesh: SpatialMesh, caches: BandCaches,
                  dst: Optional[int] = None) -> Optional[Dict]:
    """The global caches, in ``EngineState.caches`` form, from every
    rank's :func:`spatial_full_apply` caches: the row bands of every
    rank in rank order, and the entries that are not bands (the same on
    every rank) as this rank holds them. On every rank, or with ``dst``
    on that rank alone (None on the others), one collective per band, in
    the caches' order."""
    if not isinstance(caches, BandCaches):
        raise TypeError("gather_caches takes the caches spatial_full_apply "
                        "returns (a BandCaches)")
    if mesh.size == 1:
        return dict(caches)
    out = {}
    for path, slots in caches.items():
        out[path] = []
        for slot, d in enumerate(slots):
            out[path].append({
                name: (_gather(mesh, t, dst)
                       if (path, slot, name) in caches.rows else t)
                for name, t in d.items()})
    if dst is not None and mesh.index != dst:
        return None
    return out
