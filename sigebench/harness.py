"""One run of one cell: set-up, the closed loop of stacked editing sessions,
the traced steps, and the check of the window's outputs against the plain
reference.

The system under test is ``sige_torch.parallel.SessionServer``: S editing
sessions primed on their originals, each session's edit planned by
``set_masks``, and one stacked sparse forward (``step``) a denoising step
for all of them. The loop is closed: step k+1 is due when step k's
outputs are synchronised. Before a step, the sessions whose turn it is
send a new edit (``set_masks``, and the step's input changes under the
new mask); every step's input is the originals plus each session's edit
change, scaled by a factor that varies from step to step.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from . import metrics, trace as tracing
from .families import Prepared, family
from .reference.common import (FlopCount, Pass, counting, precision,
                               seeded_params)
from .reference.windows import SessionWindows
from .traffic import Traffic, generate

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "sigebench"
FORBIDDEN = ("jax", "jaxlib", "flax", "sige_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    workload: Mapping
    manifest: Mapping
    config: Mapping
    mix: Mapping


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """A workload of ``BENCHMARK.json`` with its configuration's and its
    mix's files, found by their names."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in manifest["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "sigebench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    return Cell(name, w, manifest, config, mix)


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def verdict(errs: List[float], limit: float):
    """(correct, failed): every compared output within ``limit``; a
    non-finite gap fails."""
    failed = sum(1 for e in errs if not e <= limit)
    return bool(errs) and failed == 0, failed


def step_scale(k: int) -> float:
    """The factor on every edit's change at step ``k``."""
    return 1.0 + 0.01 * (k % 7 - 3)


class Reservoir:
    """``size`` steps drawn uniformly from the seed out of however many
    the window runs (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed), 0xC0DE])
        self.kept: List[Dict] = []
        self.seen = 0

    def offer(self, make: Callable[[], Dict]) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(make())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = make()


@dataclasses.dataclass
class Record:
    """What a run measured, for the readers of ``sigebench/layers``."""

    sessions: int
    steps: int = 0
    window_s: float = 0.0
    step_s: List[float] = dataclasses.field(default_factory=list)
    enqueue_s: List[float] = dataclasses.field(default_factory=list)
    plan_s: List[float] = dataclasses.field(default_factory=list)
    step_entries: List[List[int]] = dataclasses.field(default_factory=list)
    flops: Optional[List[List[float]]] = None   # [session][entry]
    cache_bytes: int = 0
    trace: Optional[tracing.Trace] = None
    trace_steps: int = 0
    # the program's counters over the timed window; None where it has none
    counters: Optional[Dict[str, int]] = None

    def needed_flops(self) -> float:
        return sum(self.flops[i][e] for entries in self.step_entries
                   for i, e in enumerate(entries))


class Loop:
    """The server and the sessions' state between steps."""

    def __init__(self, server, prep: Prepared, traffic: Traffic, spans):
        self.server, self.prep, self.traffic = server, prep, traffic
        self.span = spans
        self.cur = [0] * traffic.sessions
        self.delta = torch.zeros_like(prep.x0)
        # (step, session, entry) in order; (step, -1, -1) as a step runs
        self.events: List[tuple] = []

    def send(self, i: int, e: int, k: int, rec: Optional[Record]) -> None:
        t0 = time.perf_counter()
        with self.span("set_masks"):
            self.server.set_masks(i, self.prep.pyramids[i][e])
        if rec is not None:
            rec.plan_s.append(time.perf_counter() - t0)
        self.delta[i].copy_(self.prep.deltas[i][e])
        self.cur[i] = e
        self.events.append((k, i, e))

    def step(self, k: int, rec: Optional[Record], sync: Callable):
        self.events.append((k, -1, -1))
        with self.span("input"):
            x = torch.add(self.prep.x0, self.delta, alpha=step_scale(k))
        t0 = time.perf_counter()
        with self.span("step"):
            y = self.server.step(x, *self.prep.extras)
        if rec is not None:
            rec.enqueue_s.append(time.perf_counter() - t0)
        with self.span("sync"):
            sync()
        return y

    def arrivals(self, k: int, rec: Optional[Record]) -> None:
        pool = self.traffic.pool
        for i in self.traffic.arrivals(k):
            self.send(i, (self.cur[i] + 1) % pool, k, rec)


def _sync_for(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def storage_bytes(tensors) -> int:
    """Bytes of the storages under ``tensors``, each counted once (the
    arithmetic of the program's ``runners/common.py storage_mb``)."""
    seen, total = set(), 0
    for t in tensors:
        s = t.untyped_storage()
        if s.data_ptr() not in seen:
            seen.add(s.data_ptr())
            total += s.nbytes()
    return total


def meta_pass(prep: Prepared, cache_dir: Optional[Path] = None):
    """The reference's pass on the meta device: the output resolutions of
    its sparse layers and its operations by region. It depends on the
    configuration and the shapes alone, so with ``cache_dir`` its result
    is kept there under their digest, and a later run reads it."""
    shapes = [list(a.shape[1:]) for a in (prep.x0,) + prep.extras]
    key = hashlib.sha256(json.dumps(
        [sorted(prep.shapes.items()), shapes,
         sorted((k, str(v)) for k, v in prep.reference_cfg.items())]
    ).encode()).hexdigest()[:24]
    path = None if cache_dir is None else cache_dir / f"meta-{key}.json"
    if path is not None and path.is_file():
        kept = json.loads(path.read_text())
        return ({tuple(r) for r in kept["consumed"]},
                {None if k is None else tuple(k): v
                 for k, v in kept["by_region"]})
    P = {k: torch.empty(v, device="meta") for k, v in prep.shapes.items()}
    meta = [torch.empty(s, device="meta") for s in shapes]
    run, count = Pass("orig"), FlopCount()
    with counting(count), torch.no_grad():
        prep.reference(P, meta[0], tuple(meta[1:]), run)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps({
            "consumed": sorted(run.out_reses),
            "by_region": [[k, v] for k, v in count.by_region.items()]}))
        os.replace(tmp, path)
    return run.out_reses, count.by_region


def prepare(cell: Cell, seed: int, device, attempts: int = 8,
            log=lambda s: None, cache_dir: Optional[Path] = None):
    """The cell's traffic and inputs from the seed. In the window layout
    the sessions' first edits must give windows of different extents (so
    that the server pins them at once, as :class:`SessionWindows`
    replays): the traffic is drawn again until they do."""
    config, mix = cell.config, cell.mix
    fam = family(config["family"])
    for attempt in range(attempts):
        traffic = generate(mix, int(config["image"]), seed, attempt)
        prep = fam.prepare(config, mix["model"], traffic, seed, device)
        t0 = time.perf_counter()
        consumed, by_region = meta_pass(prep, cache_dir)
        log(f"meta pass {time.perf_counter() - t0:.2f} s")
        if mix["layout"] != "window" or traffic.sessions == 1:
            return traffic, prep, by_region
        replay = SessionWindows(traffic.sessions, consumed)
        for i in range(traffic.sessions):
            replay.set(i, prep.pyramids[i][0])
        try:
            replay.current()
        except ValueError:
            continue
        return traffic, prep, by_region
    raise ValueError(f"{cell.name}: no draw of {attempts} gave first edits "
                     f"of different windows")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, server_hook=None,
             log=lambda s: None, cache_dir: Optional[Path] = CACHE) -> Dict:
    """Set up, run the window (and with ``trace`` the traced steps), check
    the outputs; returns the result's fields. ``control`` also reads the
    reference computed in TF32 against the fp32 one. ``server_hook`` may
    wrap the server (the tests' planted faults)."""
    from sige_torch.parallel import SessionServer

    mix = cell.mix
    sync = _sync_for(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    traffic, prep, by_region = prepare(cell, seed, device, log=log,
                                       cache_dir=cache_dir)
    marks.append(("traffic", time.perf_counter()))
    params = seeded_params(prep.shapes, seed, device)
    server = SessionServer(prep.build(), params=params,
                           bucket_min=prep.bucket_min, layout=mix["layout"],
                           device=device)
    del params
    sync()
    marks.append(("weights", time.perf_counter()))
    if server_hook is not None:
        server = server_hook(server)
    spans = tracing.Spans()
    loop = Loop(server, prep, traffic, spans)
    S, pool = traffic.sessions, traffic.pool
    server.prime(prep.x0, *prep.extras)
    sync()
    marks.append(("prime", time.perf_counter()))
    for e in range(pool):  # every edit of the pool once: pins and timings
        for i in range(S):
            loop.send(i, e, -1, None)
        loop.step(0, None, sync)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s"
                               for a, b in zip(marks, marks[1:])))

    rec = Record(sessions=S)
    reservoir = Reservoir(int(mix["compared_steps"]), seed)
    counted = tracing.counters_now()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    due, k = t0, 0
    while due - t0 < seconds:
        k += 1
        loop.arrivals(k, rec)
        y = loop.step(k, rec, sync)
        end = time.perf_counter()
        rec.step_s.append(end - due)
        rec.step_entries.append(list(loop.cur))
        reservoir.offer(lambda: {"k": k, "y": y.clone(),
                                 "entries": list(loop.cur),
                                 "events": len(loop.events)})
        due = end
    rec.steps, rec.window_s = k, due - t0
    rec.counters = tracing.counter_deltas(counted, tracing.counters_now())

    if trace:
        rec.trace, rec.trace_steps = _traced(loop, k, int(mix["trace_steps"]),
                                             sync, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    rec.cache_bytes = storage_bytes(server.model.state.tensors())
    del server, loop.server, y
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    rec.flops = [[metrics.needed_flops(by_region, prep.fracs(i, e))
                  for e in range(pool)] for i in range(S)]
    t_check = time.perf_counter()
    compared = check(prep, traffic, loop.events, reservoir.kept, seed,
                     device, control)
    log(f"window {rec.window_s:.2f} s, {rec.steps} steps; reference check "
        f"{time.perf_counter() - t_check:.2f} s")
    return {"setup_s": setup_s, "record": rec, "peak": peak,
            "compared": compared, "attempted": S * rec.steps}


def _traced(loop: Loop, k: int, n: int, sync, device):
    """``n`` more steps of the schedule under the profiler (after one that
    starts it up, outside the traced window), with the flash and session
    kernels' calls in the window recorded."""
    loop.span.on = True
    calls = tracing.CallLog()
    with tracing.profile(device) as prof:
        loop.arrivals(k + 1, None)
        loop.step(k + 1, None, sync)
        with calls.recording(), loop.span("window"):
            for j in range(2, n + 2):
                loop.arrivals(k + j, None)
                loop.step(k + j, None, sync)
    loop.span.on = False
    return tracing.reduce(prof, calls), n


def _windows_at(events, kept, consumed, S):
    """Each kept step's per-session windows, replaying the edits in the
    order they were set and the server's stacking before every step."""
    replay = SessionWindows(S, consumed)
    out, at = {}, 0
    for item in sorted(kept, key=lambda d: d["events"]):
        while at < item["events"]:
            _, i, pyramid = events[at]
            if i < 0:
                replay.current()
            else:
                replay.set(i, pyramid)
            at += 1
        out[item["k"]] = [dict(w) for w in replay.current()]
    return out


def check(prep: Prepared, traffic: Traffic, events, kept, seed, device,
          control: bool) -> Dict:
    """The kept steps' outputs against the reference, session by session,
    each as max |program - reference| / max |reference| (the reference in
    IEEE fp32); with ``control`` the TF32 reference's gap as well."""
    S = traffic.sessions
    params = seeded_params(prep.shapes, seed, device)
    # the replay takes the pyramids the events set
    ev = [(k, i, None if i < 0 else prep.pyramids[i][e])
          for k, i, e in events]
    errs, ctrl = [], []
    with precision(tf32=False), torch.no_grad():
        windows = None
        for i in range(S):
            store = {}
            orig = Pass("orig", store)
            extras = prep.extras_of(i)
            prep.reference(params, prep.x0[i], extras, orig)
            if windows is None and traffic.mix["layout"] == "window":
                windows = _windows_at(ev, kept, orig.out_reses, S)
            for item in kept:
                e = item["entries"][i]
                x = torch.add(prep.x0[i], prep.deltas[i][e],
                              alpha=step_scale(item["k"]))
                masks = {hw: torch.from_numpy(m).to(device)
                         for hw, m in prep.pyramids[i][e].items()}
                win = None if windows is None else windows[item["k"]][i]
                ref = prep.reference(params, x, extras,
                                     Pass("edit", store, masks, win))
                got = item["y"][i]
                scale = ref.abs().max().item()
                err = (got - ref).abs().max().item() / scale
                if not math.isfinite(err):
                    err = math.inf
                errs.append(err)
                if control:
                    with precision(tf32=True):
                        low = prep.reference(params, x, extras,
                                             Pass("edit", store, masks, win))
                    ctrl.append((low - ref).abs().max().item() / scale)
            del store
    return {"errs": errs, "control": ctrl}

