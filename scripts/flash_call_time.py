"""Host and device time of one flash attention call at the DDPM main
path's shapes, beside SDPA, for the port in this checkout or in another
tree of the repo.

    python3 scripts/flash_call_time.py [--root DIR]

``--root`` imports ``sige_torch`` from DIR instead of this checkout, so a
second tree (an earlier commit unpacked with ``git archive`` into a
git-ignored directory) can be measured on the same card in the same
call. For shapes (a) B=H=1 N=M=256 D=512 and (b) N=M=64 D=512 it prints
one JSON line with, for ``flash_mha`` and for
``F.scaled_dot_product_attention`` on the same inputs:

  * ``host_ms``: host time per call over CALLS back-to-back calls with
    no synchronisation (what the call costs the host that enqueues it);
  * ``call_ms``: CUDA-event time per call over the same calls (the
    larger of host and device time, plus any gaps between kernels);
  * ``device_ms``: the kernels' busy time per call in a torch.profiler
    trace.

``host_ms`` and ``call_ms`` are medians of REPS runs, the kernel's and
SDPA's runs interleaved so that both see the same host load. TF32 is
off. GPU only: exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import card_line, device_ms  # noqa: E402

CALLS = 200  # back-to-back calls per run (400 launches: below the queue)
REPS = 5
SHAPES = {"a": (1, 256, 256, 1, 512), "b": (1, 64, 64, 1, 512)}


def host_and_call_ms(fn, calls: int = CALLS):
    """(host ms, CUDA-event ms) per call over the same ``calls`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / calls
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / calls


def measure(fns):
    runs = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(10):
            fn()
    for _ in range(REPS):
        for name, fn in fns.items():
            runs[name].append(host_and_call_ms(fn))
    return {name: {"host_ms": statistics.median(h for h, _ in runs[name]),
                   "call_ms": statistics.median(c for _, c in runs[name]),
                   "device_ms": device_ms(fn)[0]}
            for name, fn in fns.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree whose sige_torch is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_call_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import torch.nn.functional as F

    from sige_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card_line(), "root": os.path.abspath(args.root),
           "module": flash.__file__}
    for label, (B, N, M, H, D) in SHAPES.items():
        q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
                   for n in (N, M, M))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        scale = D ** -0.5
        res[label] = measure({
            "kernel": lambda: flash.flash_mha(q, k, v, scale),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale)})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
