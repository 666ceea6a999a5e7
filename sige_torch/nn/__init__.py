"""SIGE engine layers, host planning and the stateful model wrapper."""

from .engine import EngineState, SIGEModel, fp32_scope, resolve_device
from .module import (Gather, Scatter, ScatterGather, ScatterWithBlockResidual,
                     SIGECtx, SIGEConv2d)
from .planner import (build_plan, choose_layout, merge_pins, plan_pins,
                      plan_stats)

__all__ = [
    "EngineState", "SIGEModel", "fp32_scope", "resolve_device", "SIGECtx",
    "Gather", "Scatter", "ScatterGather", "ScatterWithBlockResidual",
    "SIGEConv2d", "build_plan", "choose_layout", "merge_pins", "plan_pins",
    "plan_stats",
]
