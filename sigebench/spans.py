"""The port's own spans and counters in one run of a cell.

    python3 -m sigebench.spans --workload <name> --seed <n> --seconds <s>

runs the cell as ``python3 -m sigebench.run ... --trace 1`` does (the
timed window with no profiler, then ``trace_steps`` steps under
``torch.profiler``) and prints one JSON line: the per-layer metrics of
``BENCHMARK.json`` and the readers of :data:`PROGRAM_METRICS`, which read
the port's spans (``sige.*`` ranges, ``sige_torch/utils/trace.py``) and
counters; the window's ``enqueue_ms`` and end-to-end metrics; each
program span's calls, total and self ms per traced step; the ten longest
idle gaps of the device labelled by the innermost span open at their
middle; the counters' deltas over the timed window; and the mean of the
harness's ``sigebench.step`` and of ``sige.serving.step`` over the
traced steps. Standard error gets the ten spans of largest self time.

The harness's :class:`~sigebench.harness.Record` and
:class:`~sigebench.trace.Trace` do not carry spans or counters: this
module adds them to the run's objects (``Record.counters``,
``Trace.spans``, ``Trace.forward_idle_s``) by wrapping the harness's
``Record``, ``_traced`` and ``trace.reduce`` for the run. Against a
program without spans or counters the readers return None.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

from . import metrics

PROGRAM_METRICS = ("install_ms", "forward_idle_ms", "sessions_launch_us",
                   "plans_per_edit", "conv_new_shapes")

Span = Tuple[str, float, float]  # (name, start, end), profiler us


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
    without ``sigebench.`` (as ``sigebench/trace.py`` labels them)."""
    if name is None:
        return "other"
    return name.split(".", 1)[1] if name.startswith("sigebench.") else name


def program_trace(events, lo: float, hi: float) -> Dict:
    """From a profiler's events over the traced window [lo, hi] (us): the
    program spans' table, the device-idle seconds inside
    ``sige.engine.sparse``, the ten longest idle gaps labelled by the
    innermost span, and the lengths of ``sigebench.step`` and
    ``sige.serving.step`` (seconds)."""
    import torch

    from .trace import _is_device

    cuda = torch.autograd.DeviceType.CUDA
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type != cuda and lo <= e.time_range.start < hi
            and (e.name.startswith("sige.")
                 or e.name.startswith("sigebench."))]
    program = [s for s in host if s[0].startswith("sige.")]
    ivals = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in events if _is_device(e)
             and e.time_range.end > lo and e.time_range.start < hi]
    gaps = metrics.gaps(ivals, lo, hi)
    inner = [s for s in host if s[0] != "sigebench.window"]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "spans": span_table(program),
        "forward_idle_s": overlap_s(gaps, [(a, b) for n, a, b in program
                                           if n == "sige.engine.sparse"]),
        "idle_gaps": [[label(innermost((a + b) / 2, inner)), (b - a) / 1e6]
                      for a, b in longest],
        "steps_s": {n: [(b - a) / 1e6 for m, a, b in host if m == n]
                    for n in ("sigebench.step", "sige.serving.step")}}


def counters_now() -> Optional[Dict[str, int]]:
    """The program's counters, None where it has none."""
    try:
        from sige_torch.utils.trace import snapshot
    except ImportError:
        return None
    return snapshot()


def run_with_spans(cell, seed: int, seconds: float, device, t_start: float,
                   log=lambda s: None, cache_dir=None):
    """``harness.run_cell`` with the traced steps, the window's counter
    deltas put on the record (``counters``) and the program's spans on its
    trace (``spans``, ``forward_idle_s``, ``program``: the whole of
    :func:`program_trace`)."""
    import torch

    from . import harness, trace as tracing

    cuda = torch.autograd.DeviceType.CUDA
    made = []
    base, traced, reduce = harness.Record, harness._traced, tracing.reduce

    class Record(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.counters = None
            self.counters_at_start = counters_now()
            made.append(self)

    def _traced(loop, k, n, sync, dev):
        rec = made[-1]
        start, end = rec.counters_at_start, counters_now()
        if start is not None and end is not None:
            rec.counters = {key: end[key] - start[key] for key in end}
        return traced(loop, k, n, sync, dev)

    def _reduce(prof, calls):
        t = reduce(prof, calls)
        if t is None:
            return t
        events = list(prof.events())
        win = [e for e in events if e.name == "sigebench.window"
               and e.device_type != cuda][0]
        t.program = program_trace(events, win.time_range.start,
                                  win.time_range.end)
        t.spans = t.program["spans"]
        t.forward_idle_s = t.program["forward_idle_s"]
        return t

    harness.Record, harness._traced, tracing.reduce = Record, _traced, _reduce
    try:
        return harness.run_cell(cell, seed, seconds, True, device, t_start,
                                log=log, cache_dir=cache_dir)
    finally:
        harness.Record, harness._traced, tracing.reduce = (base, traced,
                                                           reduce)


def result_line(cell, out) -> Dict:
    """What :func:`main` prints of a run: the cell's per-layer metrics and
    :data:`PROGRAM_METRICS` that find something to read, ``correct``, the
    end-to-end metrics, the counters' deltas, and per traced step each
    program span's calls, total ms and self ms, the labelled gaps and the
    steps' mean ms."""
    from . import harness
    from .layers import reader

    rec = out["record"]
    names = [m["name"] for m in cell.manifest["per_layer"]
             if cell.name in m.get("workloads", [cell.name])]
    found = {}
    for name in names + [m for m in PROGRAM_METRICS if m not in names]:
        v = reader(name)(rec)
        if v is not None:
            found[name] = v
    limit = float(cell.config["limit"]["max_rel_err"])
    correct, failed = harness.verdict(out["compared"]["errs"], limit)
    line = {"correct": correct, "failed": failed, "metrics": found,
            "session_steps_per_s": metrics.session_steps_per_s(
                rec.sessions, rec.steps, rec.window_s),
            "step_ms_p95": metrics.p95_ms(rec.step_s),
            "setup_s": out["setup_s"], "counters": rec.counters}
    prog, n = getattr(rec.trace, "program", None), rec.trace_steps
    if prog is not None:
        line["spans"] = {name: [c / n, 1e3 * tot / n, 1e3 * own / n]
                         for name, (c, tot, own)
                         in sorted(prog["spans"].items())}
        line["idle_gaps"] = prog["idle_gaps"]
        line["step_mean_ms"] = {name: 1e3 * sum(v) / len(v) if v else None
                                for name, v in prog["steps_s"].items()}
    return line


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from .run import cache_dirs, card_line
    cache_dirs()

    import torch

    from . import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"sigebench: {args.workload} needs a CUDA device",
              file=sys.stderr)
        return 2
    card = card_line()
    out = run_with_spans(cell, args.seed, args.seconds, "cuda", t_start,
                         log=lambda s: print(f"sigebench: {s}",
                                             file=sys.stderr, flush=True),
                         cache_dir=harness.CACHE)
    line = {"workload": args.workload, "seed": args.seed, "card": card,
            **result_line(cell, out)}
    top = sorted(line.get("spans", {}).items(), key=lambda kv: -kv[1][2])
    print("sigebench: self ms a traced step: " + ", ".join(
        f"{name} {v[2]:.3f}" for name, v in top[:10]), file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
