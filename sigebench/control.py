"""The readings that a cell's limit is set from, on the GPU, many seeds in
one process.

    python3 -m sigebench.control --workload <name> --seconds 4 \
        --seeds 11 12 13 ... [--out chiprun_out/control.jsonl]

For each seed one run of the cell at its own load (a short window), then
per seed: the program's reading (its max_rel_err against the IEEE fp32
reference, as a run compares it) and the control's (the reference
computed in TF32, the precision below the configuration's fp32 with TF32
off, in the program's place, read the same way against the fp32
reference). The limit lies between the largest program reading and the
smallest control reading. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from sigebench.run import cache_dirs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cache_dirs()
    import torch

    from sigebench import harness

    if not torch.cuda.is_available():
        print("sigebench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                               control=True)
        c = out["compared"]
        row = {"workload": args.workload, "seed": seed,
               "program": max(c["errs"]), "control": max(c["control"]),
               "control_min_output": min(c["control"]),
               "outputs": len(c["errs"]), "steps": out["record"].steps,
               "s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    lower = max(r["program"] for r in rows)
    upper = min(r["control"] for r in rows)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "ratio": upper / lower,
                      "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
