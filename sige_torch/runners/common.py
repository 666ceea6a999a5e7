"""What the runners' ``profile()`` share: the memory breakdown beside the
peak (the counterpart of ``sige_tpu/runners/common.py _hbm_entry``,
which splits a compiled XLA program's argument bytes the same way)."""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch


def storage_mb(tensors: Iterable[torch.Tensor]) -> float:
    """MB (2**20 bytes, as ``peak_mb``) of the storages under
    ``tensors``, each counted once: what they hold resident (the plan's
    leaves are views of one buffer)."""
    seen, total = set(), 0
    for t in tensors:
        storage = t.untyped_storage()
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            total += storage.nbytes()
    return total / 2**20


def tree_leaves(tree: Mapping):
    """Every leaf of a nested dict (a device plan), in tree order."""
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from tree_leaves(v)
        else:
            yield v


def memory_entry(model, mode: str) -> Dict[str, float]:
    """The resident bytes of a profiled forward by kind: ``params_mb``
    (the module's state dict: parameters and buffers), and outside dense
    mode ``cache_mb`` (every cache slot of the current session) and
    ``plan_mb`` (the plan on the device). Dense mode reports the
    parameters alone: the caches the runner holds are not the dense
    forward's."""
    out = {"params_mb": storage_mb(model.module.state_dict().values())}
    if mode != "dense":
        out["cache_mb"] = storage_mb(model.state.tensors())
        out["plan_mb"] = storage_mb(tree_leaves(model.plan))
    return out
