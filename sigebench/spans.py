"""The port's own spans and counters in one run of a cell.

    python3 -m sigebench.spans --workload <name> --seed <n> --seconds <s>

runs the cell as ``python3 -m sigebench.run ... --trace 1`` does (the
timed window with no profiler, then ``trace_steps`` steps under
``torch.profiler``) and prints one JSON line: the cell's per-layer
metrics of ``BENCHMARK.json``; ``correct``; the window's end-to-end
metrics; the program's counters over the timed window
(``Record.counters``); per traced step each host span's calls, total
and self ms (``Trace.spans``: the port's ``sige.*`` ranges,
``sige_torch/utils/trace.py``, and the harness's ``sigebench.*``); the
ten longest idle gaps of the device labelled by the innermost span open
at their middle; and the mean ms of the harness's ``sigebench.step``
and of ``sige.serving.step`` over the traced steps. Standard error gets
the ten spans of largest self time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

from . import metrics

STEP_SPANS = ("sigebench.step", "sige.serving.step")


def result_line(cell, out) -> Dict:
    """What :func:`main` prints of a run of ``harness.run_cell`` with
    ``trace``."""
    from . import harness
    from .layers import reader

    rec = out["record"]
    found = {}
    for m in cell.manifest["per_layer"]:
        if cell.name in m.get("workloads", [cell.name]):
            v = reader(m["name"])(rec)
            if v is not None:
                found[m["name"]] = v
    limit = float(cell.config["limit"]["max_rel_err"])
    correct, failed = harness.verdict(out["compared"]["errs"], limit)
    line = {"correct": correct, "failed": failed, "metrics": found,
            "session_steps_per_s": metrics.session_steps_per_s(
                rec.sessions, rec.steps, rec.window_s),
            "step_ms_p95": metrics.p95_ms(rec.step_s),
            "setup_s": out["setup_s"], "counters": rec.counters}
    if rec.trace is not None:
        n, table = rec.trace_steps, rec.trace.spans
        line["spans"] = {name: [c / n, 1e3 * tot / n, 1e3 * own / n]
                         for name, (c, tot, own) in sorted(table.items())}
        line["idle_gaps"] = rec.trace.idle_gaps
        line["step_mean_ms"] = {name: 1e3 * table[name][1] / table[name][0]
                                if name in table else None
                                for name in STEP_SPANS}
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
    out = harness.run_cell(cell, args.seed, args.seconds, True, "cuda",
                           t_start,
                           log=lambda s: print(f"sigebench: {s}",
                                               file=sys.stderr, flush=True))
    line = {"workload": args.workload, "seed": args.seed, "card": card,
            **result_line(cell, out)}
    top = sorted(line.get("spans", {}).items(), key=lambda kv: -kv[1][2])
    print("sigebench: self ms a traced step: " + ", ".join(
        f"{name} {v[2]:.3f}" for name, v in top[:10]), file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
