"""A (dp, tp) mesh over ``torch.distributed`` ranks, one process per card:
the port of ``sige_tpu.parallel.mesh``.

``sige_tpu`` is one controller over a ``jax.sharding.Mesh``: it
replicates the weights, shards the request batch (and the caches' batch
axis) over ``dp``, and leaves ``tp`` as a channel sharding constraint
that XLA lowers to all-gathers. The port runs one process per card
instead, each called with the same global arguments:

  * **dp** — rank ``(d, t)`` computes rows ``[d * n, (d + 1) * n)`` of a
    batch of ``dp * n`` (requests of ``TwinStepServer``, sessions of
    ``SessionServer``); no collective runs inside a step;
  * **tp** — the ranks of one dp group compute the same rows: the port
    shards no channels, and ``sige_tpu``'s tp changes where its numbers
    live, not what they are.

:func:`replicate` broadcasts rank 0's weights once, at construction;
:func:`shard_batch` and :func:`shard_cache` keep this rank's rows;
:func:`gather_batch` is the one all-gather that assembles the global batch
after a step, where a JAX caller would read the global array back. A
world of one (no process group) is a mesh of one: every function returns
its input, and the servers behave as on one card.

Process groups come from the caller: ``torch.distributed`` with NCCL on
several cards (``torchrun --nproc_per_node=N``), gloo on the CPU or for
ranks sharing one card (NCCL refuses two ranks on one device). Under gloo
the collectives stage CUDA tensors through the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from ..nn.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` x ``tp`` ranks of ``group`` (None: the world, or no process
    group at all when ``dp * tp`` is 1); this rank's coordinates
    ``dp_index`` and ``tp_index`` (rank = dp_index * tp + tp_index); the
    device its tensors live on."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` (``n`` a multiple of dp)."""
        if n % self.dp:
            raise ValueError(f"batch {n} over dp={self.dp}")
        k = n // self.dp
        return slice(self.dp_index * k, (self.dp_index + 1) * k)


def _world(group) -> tuple:
    """(rank, world size) in ``group``; (0, 1) without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise RuntimeError("a process group was given, but "
                               "torch.distributed is not initialized")
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, group=None,
              device=None) -> Mesh:
    """The (dp, tp) mesh of the ranks of ``group`` (the world by default),
    one rank per card: ``n_devices`` (the world size by default) must be
    the group's size and a multiple of ``tp``. On several ranks the
    device is ``cuda:<local rank>`` (``LOCAL_RANK`` as ``torchrun`` sets
    it, else the rank modulo the visible cards) unless ``device`` names
    another, e.g. ``"cpu"``; a world of one takes ``device`` as a server
    on one card does (None: the current CUDA device)."""
    rank, world = _world(group)
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: the "
                         f"port runs one process per card")
    if tp < 1 or n % tp:
        raise ValueError(f"{n} ranks do not split into tp={tp}")
    return Mesh(n // tp, tp, rank // tp, rank % tp, group,
                rank_device(rank, world, device))


def rank_device(rank: int, world: int, device=None) -> torch.device:
    """A rank's device: ``device`` where given; else on several ranks
    ``cuda:<local rank>`` (``LOCAL_RANK`` as ``torchrun`` sets it, else
    the rank modulo the visible cards), and on one the current CUDA
    device."""
    if device is None and world > 1 and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = f"cuda:{local}"
    return resolve_device(device)


def staging(mesh) -> torch.device:
    """Where a collective of ``mesh``'s group takes its tensors: the host
    under gloo (CUDA tensors are staged through it), else the rank's
    device."""
    if dist.get_backend(mesh.group) == dist.Backend.GLOO:
        return torch.device("cpu")
    return mesh.device


def replicate(mesh: Mesh, state_dict: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Rank 0's ``state_dict`` on every rank, at construction: one
    broadcast from rank 0 of the mesh's group of every tensor packed into
    one byte buffer, in key order (each at an 8-byte offset), split into
    views of it. The values on other ranks are overwritten; their keys,
    shapes and dtypes must agree."""
    if mesh.size == 1:
        return dict(state_dict)
    via = staging(mesh)
    keys = sorted(state_dict)
    ts = [state_dict[k].detach().to(via).contiguous() for k in keys]
    sizes = [t.numel() * t.element_size() for t in ts]
    flat = torch.zeros(sum(-(-n // 8) * 8 for n in sizes), dtype=torch.uint8,
                       device=via)
    pos = 0
    for t, n in zip(ts, sizes):
        flat[pos:pos + n] = t.reshape(-1).view(torch.uint8)
        pos += -(-n // 8) * 8
    src = dist.get_global_rank(mesh.group, 0) if mesh.group else 0
    dist.broadcast(flat, src=src, group=mesh.group)
    out, pos = {}, 0
    for k, t, n in zip(keys, ts, sizes):
        out[k] = flat[pos:pos + n].view(t.dtype).view(t.shape)
        pos += -(-n // 8) * 8
    return out


def shard_batch(mesh: Mesh, x):
    """This rank's rows of ``x`` along its batch axis (axis 0); anything
    that is not a tensor with a batch axis passes as it is."""
    if mesh.dp == 1 or not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    return x[mesh.rows(x.shape[0])]


def shard_cache(mesh: Mesh, caches: Mapping[str, List[Mapping]],
                batch: int) -> Dict[str, List[Dict]]:
    """This rank's rows of every cache map of ``caches`` (the form of
    ``EngineState.caches``) whose leading axis is the request batch
    ``batch``; the others (per-layer constants) pass as they are. For
    caches filled elsewhere at the global batch, before a rank's
    ``SIGEModel.adopt_full`` (the servers fill each rank's own rows)."""
    def keep(t):
        return t[mesh.rows(batch)] if t.ndim and t.shape[0] == batch else t

    return {path: [{k: keep(t) for k, t in d.items()} for d in slots]
            for path, slots in caches.items()}


def gather_batch(mesh: Mesh, y: torch.Tensor) -> torch.Tensor:
    """The global batch from every dp rank's rows ``y``, in rank order, on
    every rank: one all-gather, run after a step (the counterpart of
    reading a JAX global array back). Ranks of one dp group hold the same
    rows; the first of each is taken."""
    if mesh.size == 1:
        return y
    whole = all_gather_cat(mesh, y)
    return whole.unflatten(0, (mesh.size, -1))[::mesh.tp].flatten(0, 1)


def all_gather_cat(mesh, t: torch.Tensor, dim: int = 0,
                   dst: Optional[int] = None) -> Optional[torch.Tensor]:
    """Every rank's ``t`` (all of one shape) concatenated along ``dim`` in
    the rank order of ``mesh``'s group, on ``t``'s device: on every rank
    (``dst`` None, one all-gather) or on the group's rank ``dst`` alone
    (one gather; None on the others)."""
    part = t.detach().to(staging(mesh)).contiguous()
    here = dst is None or dist.get_rank(mesh.group) == dst
    parts = [torch.empty_like(part) for _ in range(mesh.size)] if here \
        else None
    if dst is None:
        dist.all_gather(parts, part, group=mesh.group)
    else:
        root = dist.get_global_rank(mesh.group, dst) if mesh.group else dst
        dist.gather(part, parts, dst=root, group=mesh.group)
    return None if parts is None else torch.cat(parts, dim).to(t.device)
