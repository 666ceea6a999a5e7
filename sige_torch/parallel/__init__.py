"""Serving: S editing sessions on one GPU, each with its own plan (the
port of ``sige_tpu.parallel.serving.SessionServer``; the mesh modules
come with a later slice)."""

from .serving import SessionServer

__all__ = ["SessionServer"]
