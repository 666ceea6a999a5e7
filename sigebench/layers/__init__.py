"""Per-layer metrics, one reader each, found by the metric's name: a
module ``<name>.py`` with ``read(record) -> float | None`` over the run's
:class:`sigebench.harness.Record`. A reader that finds nothing to read
returns None, and the harness leaves the metric out of the line."""

import importlib


def reader(name: str):
    return importlib.import_module(f"{__name__}.{name}").read
