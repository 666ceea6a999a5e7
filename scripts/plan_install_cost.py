"""What installing the stacked plan costs after each edit, with no
profiler running, on one of the benchmark's cells (default: DDPM
church256, 8 stacked sessions, window layout).

    python3 scripts/plan_install_cost.py [--workload CELL] [--seed S]

Builds the cell's ``SessionServer`` as ``sigebench`` does (weights and
edits from the seed) and primes it, then sends the pool's edits in the
warm-up's order (every session's first edit, then every session's
second, ...). After each edit it times, on the host clock and with the
card synchronised before each, the install this tree runs
(``ResidentPlan.update``: the row written in place and one copy of the
whole plan, or a full build on a new layout) and the install the tree
before it ran on the same plans (a fresh ``np.stack`` of every leaf, a
compare of every leaf with the last upload by value, and one packed
copy of the changed leaves from pageable memory). It prints one JSON
line: the stacked plan's leaves (int and bool), its host bytes and
packed bytes, and for each edit the leaves it changed, the path it took
and the two host times, with the medians over the row-path edits. GPU
only.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def upload_changed(device, prev_host: Optional[Mapping],
                   prev_dev: Optional[Mapping], host: Mapping) -> Dict:
    """The earlier install's upload: the device tensors of leaves whose
    host array equals the last upload's are kept (those of one packed
    buffer, the one they keep most bytes of), the others move in one
    packed copy."""
    import torch

    from sige_torch.nn.engine import upload_leaves
    from sige_torch.nn.planner import get_path, plan_leaves

    leaves = plan_leaves(host)
    reuse = [None] * len(leaves)
    if prev_host is not None and prev_dev is not None:
        prev = plan_leaves(prev_host)
        if [p for p, _ in prev] == [p for p, _ in leaves]:
            reuse = [get_path(prev_dev, path)
                     if (a.shape == b.shape and a.dtype == b.dtype
                         and np.array_equal(a, b)) else None
                     for (path, a), (_, b) in zip(leaves, prev)]
    kept: Dict[int, int] = {}
    for r in reuse:
        if r is not None:
            buf = r.untyped_storage().data_ptr()
            kept[buf] = kept.get(buf, 0) + r.nbytes
    main = max(kept, key=kept.get, default=None)
    reuse = [r if r is not None and r.untyped_storage().data_ptr() == main
             else None for r in reuse]
    fresh = iter(upload_leaves(
        [a for (_, a), r in zip(leaves, reuse) if r is None],
        torch.device(device)))
    out: Dict = {}
    for (path, _), r in zip(leaves, reuse):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = r if r is not None else next(fresh)
    return out


def measure(server, traffic, prep, sync) -> Dict:
    """The plan's sizes and each pool edit's install, both ways (see the
    module's docstring), on a primed ``server``."""
    from sige_torch.nn.engine import pack_offsets
    from sige_torch.nn.planner import plan_leaves, stack_plans
    from sige_torch.parallel import ResidentPlan
    from sige_torch.utils import trace

    S, stack = traffic.sessions, server._stack
    plan = ResidentPlan(server.model.device, slice(0, S))
    prev_host = prev_dev = None
    edits = []
    for e in range(traffic.pool):
        for i in range(S):
            stack.set(i, prep.pyramids[i][e])
            if any(p is None for p in stack.plans):
                continue
            full = trace.counters["plan_full_installs"]
            sync()
            t0 = time.perf_counter()
            plan.update(stack)
            row_ms = 1e3 * (time.perf_counter() - t0)
            sync()
            path = ("full" if trace.counters["plan_full_installs"] > full
                    else "row")
            t0 = time.perf_counter()
            host = stack_plans(stack.plans)
            dev = upload_changed(server.model.device, prev_host, prev_dev,
                                 host)
            parent_ms = 1e3 * (time.perf_counter() - t0)
            sync()
            changed = None
            if prev_host is not None:
                a, b = dict(plan_leaves(prev_host)), dict(plan_leaves(host))
                changed = sum(1 for k, v in b.items() if k not in a
                              or a[k].shape != v.shape
                              or not np.array_equal(a[k], v))
            edits.append({"edit": e, "session": i, "path": path,
                          "changed_leaves": changed, "parent_ms": parent_ms,
                          "row_ms": row_ms})
            prev_host, prev_dev = host, dev
    leaves = [a for _, a in plan_leaves(stack.stacked())]
    rows = [x for x in edits if x["path"] == "row"]
    out = {"sessions": S, "leaves": len(leaves),
           "int_leaves": sum(a.dtype != np.bool_ for a in leaves),
           "bool_leaves": sum(a.dtype == np.bool_ for a in leaves),
           "host_bytes": sum(a.nbytes for a in leaves),
           "packed_bytes": pack_offsets(leaves)[1],
           "row_installs": len(rows), "full_installs": len(edits) - len(rows)}
    if rows:
        changed = [x["changed_leaves"] for x in rows
                   if x["changed_leaves"] is not None]
        out.update({
            "changed_leaves_range": [min(changed), max(changed)],
            "parent_ms_median": statistics.median(x["parent_ms"]
                                                  for x in rows),
            "row_ms_median": statistics.median(x["row_ms"] for x in rows)})
    out["edits"] = edits
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="ddpm_church256.window_s8")
    ap.add_argument("--seed", type=int, default=7001)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("plan_install_cost: no CUDA device", file=sys.stderr)
        return 1
    from sigebench import harness
    from sigebench.reference.common import seeded_params
    from sigebench.run import card_line
    from sige_torch.parallel import SessionServer

    cell = harness.load_cell(args.workload)
    traffic, prep, _ = harness.prepare(cell, args.seed, "cuda")
    server = SessionServer(prep.build(), params=seeded_params(
        prep.shapes, args.seed, "cuda"), bucket_min=prep.bucket_min,
        layout=cell.mix["layout"], device="cuda")
    server.prime(prep.x0, *prep.extras)
    torch.cuda.synchronize()
    line = {"card": card_line(), "workload": args.workload,
            "seed": args.seed}
    line.update(measure(server, traffic, prep, torch.cuda.synchronize))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
