"""The traced steps: the harness's spans, the shapes of the flash and
session kernels' calls, the program's counters, and the reduction of a
``torch.profiler`` trace to what the per-layer readers take.

Spans are ``torch.profiler.record_function`` ranges named
``sigebench.<name>`` around each call into the program (``set_masks``,
``input``, ``step``, ``sync``) and around the traced steps
(``window``); outside a traced run they cost nothing. The program's own
spans are host ranges named ``sige.<layer>.<name>``
(``sige_torch/utils/trace.py``), its counters plain integers read by
:func:`counters_now`. The hand-written kernels launch through ctypes, so
the profiler sees their names but not their shapes: while tracing, the
port's launch wrappers are wrapped to log each call's shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from . import metrics

CONV_OPS = ("aten::cudnn_convolution", "aten::_convolution",
            "aten::convolution", "aten::conv2d",
            "aten::cudnn_convolution_add_relu", "aten::cudnn_convolution_relu")
FLASH_KERNELS = ("flash_fwd_f32", "flash_combine_f32")
SESSION_KERNELS = ("crop_sessions_f32", "paste_sessions_f32")

Span = Tuple[str, float, float]  # (name, start, end), profiler us


class Spans:
    """``spans(name)``: a ``sigebench.<name>`` range while ``on``."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"sigebench.{name}")


class CallLog:
    """The shapes of every flash and session kernel launch while
    :meth:`recording`."""

    def __init__(self):
        self.flash: List[Tuple] = []     # (B, N, M, H, D, bias rows)
        self.crop: List[Dict] = []
        self.paste: List[Dict] = []

    @contextlib.contextmanager
    def recording(self):
        from sige_torch.ops import flash, sessions

        launch, crop, paste = (flash._launch, sessions._crop_cuda,
                               sessions._paste_cuda)

        def flash_launch(qh, kh, vh, scale, bias=None, splits=None):
            B, N, H, D = qh.shape
            M = kh.shape[1]
            rows = 0 if bias is None else (1 if bias.ndim == 1
                                           else int(bias.shape[0]))
            self.flash.append((B, N, M, H, D, rows))
            return launch(qh, kh, vh, scale, bias, splits)

        def crop_launch(x, org, EH, EW, edge, *rest):
            before = sessions.crop_sessions.launches
            out = crop(x, org, EH, EW, edge, *rest)
            if sessions.crop_sessions.launches == before + 1:
                self.crop.append({"x": tuple(x.shape), "elem": x.element_size(),
                                  "EH": EH, "EW": EW, "org": org,
                                  "clamp": bool(rest[-1])})
            return out

        def paste_launch(base, win, org, cov, clamp):
            before = sessions.paste_sessions.launches
            out = paste(base, win, org, cov, clamp)
            if sessions.paste_sessions.launches == before + 1:
                self.paste.append({"base": tuple(base.shape),
                                   "elem": out.element_size(),
                                   "in_elem": win.element_size()})
            return out

        flash._launch, sessions._crop_cuda, sessions._paste_cuda = (
            flash_launch, crop_launch, paste_launch)
        try:
            yield self
        finally:
            flash._launch, sessions._crop_cuda, sessions._paste_cuda = (
                launch, crop, paste)

    def flash_bound_s(self) -> float:
        return sum(metrics.flash_bound_s(*c) for c in self.flash)

    def session_bytes(self) -> float:
        """Each call's bytes in and out once: a crop writes its windows
        and reads their pixels inside the image; a paste writes the whole
        map and reads each pixel once, from the window or from the
        base."""
        total = 0.0
        for c in self.crop:
            N, H, W, C = c["x"]
            org = c["org"]
            if isinstance(org, torch.Tensor):
                o = org.detach().cpu().numpy().astype(np.int64)
                if o.shape[-1] == 4:  # 4-form metas: the virtual origin
                    o = o[:, :2] - o[:, 2:4]
                S = o.shape[0]
            else:
                o, S = np.array([[int(org[0]), int(org[1])]]), 1
            inside = metrics.in_image(o, S, H, W, c["EH"], c["EW"],
                                      c["clamp"])
            total += c["elem"] * C * (N * c["EH"] * c["EW"]
                                      + (N // S) * inside)
        for c in self.paste:
            N, H, W, C = c["base"]
            total += N * H * W * C * (c["elem"] + c["in_elem"])
        return total


@contextlib.contextmanager
def profile(device):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


@dataclasses.dataclass
class Trace:
    """A traced window reduced: seconds busy (the union of device
    intervals), the window's length, device seconds of the conv, flash
    and session kernels, the calls' bounds, the top kernels, the longest
    idle gaps labelled by the innermost span open at their middle, the
    host spans' table (:func:`span_table`) and the device-idle seconds
    inside the program's ``sige.engine.sparse``."""

    window_s: float
    busy_s: float
    conv_s: float
    flash_s: float
    session_s: float
    flash_bound_s: float
    session_bytes: float
    device_ops: List[List]
    idle_gaps: List[List]
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    forward_idle_s: float = 0.0


def counters_now() -> Optional[Dict[str, int]]:
    """The program's counters, None where it has none."""
    try:
        from sige_torch.utils.trace import snapshot
    except ImportError:
        return None
    return snapshot()


def counter_deltas(start: Optional[Dict[str, int]],
                   end: Optional[Dict[str, int]]) -> Optional[Dict[str, int]]:
    if start is None or end is None:
        return None
    return {key: end[key] - start[key] for key in end}


def span_table(spans: Iterable[Span]) -> Dict[str, List[float]]:
    """``{name: [calls, total_s, self_s]}`` of ranges that nest as a call
    stack (one thread's): a span's self time is its length less the
    lengths of the spans directly inside it."""
    out: Dict[str, List[float]] = {}
    stack: List[List] = []  # [name, (start, end), us of direct children]

    def close(entry):
        name, (a, b), child = entry[0], entry[1], entry[2]
        row = out.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (b - a) / 1e6
        row[2] += (b - a - child) / 1e6

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][1][1] <= a:
            close(stack.pop())
        if stack:
            stack[-1][2] += b - a
        stack.append([name, (a, b), 0.0])
    while stack:
        close(stack.pop())
    return out


def overlap_s(gaps: Iterable[Tuple[float, float]],
              intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds of the gaps ([a, b], us) that lie inside the union of
    ``intervals``: the intersection, not a midpoint test."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for ga, gb in gaps:
        for a, b in merged:
            total += max(0.0, min(gb, b) - max(ga, a))
    return total / 1e6


def innermost(t: float, spans: Iterable[Span]) -> Optional[str]:
    """The name of the innermost span open at ``t`` (the latest to start
    of those holding it), None where none is."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return None if best is None else best[0]


def label(name: Optional[str]) -> str:
    """A gap's label: a program span by its whole name, a harness span
    without ``sigebench.``."""
    if name is None:
        return "other"
    return name.split(".", 1)[1] if name.startswith("sigebench.") else name


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set on the GPU (not the
    annotations the profiler mirrors from the host's ranges)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("sigebench."))


def _is_span(e) -> bool:
    """A host range of the program (``sige.``) or of the harness."""
    return (e.device_type != torch.autograd.DeviceType.CUDA
            and e.name.startswith(("sige.", "sigebench.")))


def reduce(prof, calls: CallLog) -> Optional[Trace]:
    events = list(prof.events())
    window = [e for e in events
              if _is_span(e) and e.name == "sigebench.window"]
    if not window:
        return None
    lo, hi = window[0].time_range.start, window[0].time_range.end
    dev = [e for e in events if _is_device(e)
           and e.time_range.end > lo and e.time_range.start < hi]
    ivals = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in dev]
    busy = metrics.union_s(ivals) / 1e6
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    host = [e for e in events if e.device_type
            != torch.autograd.DeviceType.CUDA]
    conv = sum(k.duration for e in host if e.name in CONV_OPS
               and lo <= e.time_range.start < hi for k in e.kernels) / 1e6

    def named(keys):
        return sum(v for n, v in by_name.items() if any(k in n for k in keys))

    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in host if _is_span(e)
                    and lo <= e.time_range.start < hi),
                   key=lambda s: (s[1], -s[2]))
    inner = [s for s in spans if s[0] != "sigebench.window"]
    gaps = metrics.gaps(ivals, lo, hi)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return Trace(
        window_s=(hi - lo) / 1e6, busy_s=busy, conv_s=conv,
        flash_s=named(FLASH_KERNELS), session_s=named(SESSION_KERNELS),
        flash_bound_s=calls.flash_bound_s(),
        session_bytes=calls.session_bytes(),
        device_ops=[[n, v] for n, v in sorted(by_name.items(),
                                              key=lambda x: -x[1])[:10]],
        idle_gaps=[[label(innermost((a + b) / 2, inner)), (b - a) / 1e6]
                   for a, b in longest],
        spans=span_table(spans),
        forward_idle_s=overlap_s(gaps, [(a, b) for n, a, b in spans
                                        if n == "sige.engine.sparse"]))
