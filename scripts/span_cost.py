"""What the port's spans and counters cost with no profiler running, on
one of the benchmark's cells (default: DDPM church256, 8 stacked
sessions, window layout).

    python3 scripts/span_cost.py [--root DIR] [--workload CELL] \
        [--steps N] [--seed S]

Builds the cell's ``SessionServer`` as ``sigebench`` does (weights and
edits from the seed, every edit of the pool sent once so that the pins
and cuDNN's timings are final), fixes each session's edit, and times N
steady steps: the host ms of each ``SessionServer.step`` call (the
enqueue, no new plan to install) and the ms to its outputs synchronised
(``step_ms``). ``--root`` imports ``sige_torch`` and ``sigebench`` from DIR
instead of this checkout, so an earlier tree (unpacked with ``git
archive`` into a git-ignored directory) is timed on the same card in the
same call; run the two trees in turns. Where the tree has
``sige_torch/utils/trace.py`` the script also counts the span calls and
the convolution keys of a step and times one of each on this host
(``timeit``, the off path: no profiler), and prints their product as the
estimated cost a step. One JSON line; GPU only.
"""

import argparse
import json
import os
import statistics
import sys
import time
import timeit
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, number=200000):
    return 1e6 * min(timeit.repeat(fn, number=number, repeat=5)) / number


def off_path(trace, server, x, extras, sync, device="cuda", steps=20):
    """Span calls and conv keys a step, and the host us of one of each
    with no profiler."""
    import torch

    calls = {"span": 0, "conv_key": 0}
    span, conv_key = trace.span, trace.conv_key

    def counted_span(name):
        calls["span"] += 1
        return span(name)

    def counted_key(key):
        calls["conv_key"] += 1
        return conv_key(key)

    trace.span, trace.conv_key = counted_span, counted_key
    try:
        for _ in range(steps):
            server.step(x, *extras)
            sync()
    finally:
        trace.span, trace.conv_key = span, conv_key

    def with_span():
        with trace.span("sige.op.conv"):
            pass

    def bare():
        pass

    xc = torch.empty(8, 48, 48, 128, device=device).permute(0, 3, 1, 2)
    w = torch.empty(128, 128, 3, 3, device=device)

    def key():
        if trace.engine_scopes:
            trace.conv_key((xc.shape, xc.stride(1) == 1, w.shape, (1, 1),
                            (1, 1), 1, xc.dtype))

    trace.engine_scopes += 1
    try:
        key()
        span_us = per_call_us(with_span) - per_call_us(bare)
        key_us = per_call_us(key) - per_call_us(bare)
    finally:
        trace.engine_scopes -= 1
    n_span, n_key = calls["span"] / steps, calls["conv_key"] / steps
    return {"spans_a_step": n_span, "conv_keys_a_step": n_key,
            "span_us": span_us, "conv_key_us": key_us,
            "estimate_ms_a_step": (n_span * span_us + n_key * key_us) / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree whose sige_torch and sigebench are timed")
    ap.add_argument("--workload", default="ddpm_church256.window_s8")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=2200000101)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 1
    from sigebench import harness
    from sigebench.reference.common import seeded_params
    from sigebench.run import card_line
    from sige_torch.parallel import SessionServer

    t0 = time.perf_counter()
    cell = harness.load_cell(args.workload, root=Path(root))
    traffic, prep, _ = harness.prepare(cell, args.seed, "cuda")
    server = SessionServer(prep.build(), params=seeded_params(
        prep.shapes, args.seed, "cuda"), bucket_min=prep.bucket_min,
        layout=cell.mix["layout"], device="cuda")
    sync = torch.cuda.synchronize
    server.prime(prep.x0, *prep.extras)
    for e in range(traffic.pool):
        for i in range(traffic.sessions):
            server.set_masks(i, prep.pyramids[i][e])
        server.step(prep.x0, *prep.extras)
        sync()
    for i in range(traffic.sessions):  # a fixed edit a session
        server.set_masks(i, prep.pyramids[i][i % traffic.pool])
    delta = torch.stack([prep.deltas[i][i % traffic.pool]
                         for i in range(traffic.sessions)])
    x = prep.x0 + delta
    for _ in range(20):
        server.step(x, *prep.extras)
        sync()
    setup_s = time.perf_counter() - t0
    enqueue, step = [], []
    for _ in range(args.steps):
        t = time.perf_counter()
        server.step(x, *prep.extras)
        enqueue.append(1e3 * (time.perf_counter() - t))
        sync()
        step.append(1e3 * (time.perf_counter() - t))
    line = {"card": card_line(), "root": root, "workload": args.workload,
            "module": sys.modules["sige_torch"].__file__,
            "steps": args.steps, "setup_s": setup_s}
    for name, v in (("enqueue_ms", enqueue), ("step_ms", step)):
        q = statistics.quantiles(v, n=4)
        line.update({f"{name}_median": statistics.median(v),
                     f"{name}_mean": statistics.fmean(v),
                     f"{name}_quartiles": [q[0], q[2]]})
    try:
        from sige_torch.utils import trace
    except ImportError:
        trace = None
    if trace is not None:
        line.update(off_path(trace, server, x, prep.extras, sync))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
