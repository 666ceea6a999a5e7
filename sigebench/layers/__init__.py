"""Per-layer metrics, one reader each, found by the metric's name: a
module ``<name>.py`` with ``read(record) -> float | None`` over the run's
:class:`sigebench.harness.Record`. A reader that finds nothing to read
returns None, and the harness leaves the metric out of the line.

A quantity that cells reporting different end-to-end metrics read is
split by name: ``<name>.<part>`` (for example ``plan_ms.host_paced``,
which moves another end-to-end metric than ``plan_ms``) is read by
``<name>.py``, so a split needs a ``BENCHMARK.json`` entry and no code."""

import importlib


def reader(name: str):
    return importlib.import_module(f"{__name__}.{name.split('.')[0]}").read
