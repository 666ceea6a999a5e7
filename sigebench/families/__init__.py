"""Model families: how a configuration's file becomes the program's module,
the inputs of its sessions and the reference's call. One file per family,
found by the ``family`` key of a configuration's file."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

IntPair = Tuple[int, int]


@dataclasses.dataclass
class Prepared:
    """One cell's model and inputs, built from the seed.

    ``x0`` [S, B, ...] the originals the server is primed with and
    ``extras`` the other [S, B, ...] arguments of every call; ``deltas``
    [S][pool] of [B, ...]: an edit's change of the input (zero outside its
    mask); ``pyramids`` [S][pool] the mask pyramids handed to
    ``set_masks``; ``build`` makes the program's module (uninitialised) on
    a device; ``shapes`` the weights' names and shapes; ``reference``
    (P, x [B, ...], a session's extras, Pass) -> output runs the plain
    reference."""

    x0: torch.Tensor
    extras: Tuple[torch.Tensor, ...]
    deltas: List[List[torch.Tensor]]
    pyramids: List[List[Dict[IntPair, np.ndarray]]]
    build: Callable[[], torch.nn.Module]
    shapes: Dict[str, tuple]
    reference: Callable
    reference_cfg: Mapping
    bucket_min: int

    def extras_of(self, i: int) -> Tuple[torch.Tensor, ...]:
        return tuple(a[i] for a in self.extras)

    def fracs(self, i: int, e: int) -> Dict[IntPair, float]:
        """The share of each resolution the edit's mask covers."""
        return {hw: float(np.mean(m)) for hw, m in self.pyramids[i][e].items()}


def family(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def tuples(cfg: Mapping) -> Dict:
    """A configuration's JSON values with lists as tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def linear_alphas_cumprod(total: int, beta_start: float, beta_end: float):
    betas = np.linspace(beta_start, beta_end, total, dtype=np.float64)
    return np.cumprod(1.0 - betas)
