"""Run one cell of the benchmark on the GPU and print its result line.

    python3 -m sigebench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the cell's configuration and traffic are
found by the names in ``BENCHMARK.json``. With ``--trace 0`` the line's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (the window, then ``trace_steps`` steps under the
profiler), and standard error gets the program's ten spans of largest
self time a traced step. The last lines on standard error, and the
line's last key, give each number compared with the reference beside its
limit. Exits non-zero, printing no result, without a CUDA device, when
the outputs cannot be checked, or when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the port's own kernels build into ``build/sige_torch``)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()

    import torch

    from sigebench import harness
    from sigebench.layers import reader

    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sigebench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"sigebench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START,
                           log=lambda s: print(f"sigebench: {s}",
                                               file=sys.stderr, flush=True))
    rec = out["record"]
    units = {m["name"]: m["unit"] for m in
             cell.manifest["end_to_end"] + cell.manifest["per_layer"]}
    metrics = {}
    if args.trace:
        for m in cell.manifest["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = metric(v, units[m["name"]])
    else:
        from sigebench.metrics import p95_ms, session_steps_per_s
        values = {
            "session_steps_per_s": session_steps_per_s(
                rec.sessions, rec.steps, rec.window_s),
            "step_ms_p95": p95_ms(rec.step_s),
            "setup_s": out["setup_s"]}
        for m in cell.manifest["end_to_end"]:
            if args.workload in m.get("workloads", [args.workload]):
                metrics[m["name"]] = metric(values[m["name"]], m["unit"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(out["peak"])}
    if args.trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        top = sorted(((n, v[2]) for n, v in rec.trace.spans.items()
                      if n.startswith("sige.")), key=lambda kv: -kv[1])
        print("sigebench: program spans, self ms a traced step: " + ", ".join(
            f"{n} {1e3 * own / rec.trace_steps:.3f}" for n, own in top[:10]),
            file=sys.stderr, flush=True)

    limit = float(cell.config["limit"]["max_rel_err"])
    errs = out["compared"]["errs"]
    worst = max(errs) if errs else float("inf")
    correct, failed = harness.verdict(errs, limit)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"sigebench: loaded {', '.join(found)}: the run may not use "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": failed, "metrics": metrics, "device": device}
    if args.trace and rec.trace is not None:
        line["breakdown"] = {"device_ops": rec.trace.device_ops,
                             "idle_gaps": rec.trace.idle_gaps}
    line["card"] = card
    line["compared"] = {"max_rel_err": {"value": worst, "limit": limit,
                                        "outputs": len(errs)}}
    print(json.dumps(line), flush=True)
    print(f"compared: max_rel_err {worst!r} limit {limit!r} over "
          f"{len(errs)} session outputs ({failed} over the limit)",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
