"""Interactive editing demo: the demo runners with per-step cache slots,
the canvas ops, a PNG codec and the HTTP server (the reference's PyQt app
as a web UI; reference: diffusion_demo/)."""

from .runner import DemoRunner, DemoSession, MultiSessionDemoRunner

__all__ = ["DemoRunner", "DemoSession", "MultiSessionDemoRunner"]
