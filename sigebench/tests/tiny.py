"""Tiny cells for the CPU tests: the benchmark's configurations cut by
their family's ``TINY`` (``sigebench/families/<family>.py``: a few
channels and a small image), with mixes scaled to them. The harness runs
them on the CPU through the port's plain versions of its kernels."""

import copy
import json
from pathlib import Path
from typing import Mapping

from sigebench.families import family
from sigebench.harness import Cell

ROOT = Path(__file__).resolve().parents[2]


def _json(path):
    return json.loads((ROOT / path).read_text())


def merge(dst: dict, src: Mapping) -> dict:
    """``src`` into ``dst``: a mapping into the mapping under its key,
    any other value in place of the one there."""
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def cell(config: str, traffic: str, **mix) -> Cell:
    """``config`` x ``traffic`` from the repo's files with the model cut
    by its family's ``TINY`` and the mix's fields overridden by ``mix``."""
    manifest = _json("BENCHMARK.json")
    conf = _json(f"sigebench/configs/{config}.json")
    merge(conf, family(conf["family"]).TINY)
    m = dict(_json(f"sigebench/traffic/{traffic}.json"))
    m.update(sessions=3, pool=3, trace_steps=3, compared_steps=3)
    m.update(mix)
    return Cell(f"{config}.{traffic}", {"chips": 1}, manifest, conf, m)
