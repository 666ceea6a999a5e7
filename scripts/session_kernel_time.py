"""Device time of the session kernels (``crop_sessions_f32``,
``paste_sessions_f32``) at the stacked DDPM path's main shapes, beside
their bound and a copy of the same output bytes, for the port in this
checkout or in another tree of the repo.

    python3 scripts/session_kernel_time.py [--root DIR] [--sessions S]

``--root`` imports ``sige_torch`` from DIR instead of this checkout, so a
second tree (an earlier commit unpacked with ``git archive`` into a
git-ignored directory) can be measured on the same card in the same
call. The shapes are those of ``chip_smoke.py --phase sessions`` at S
sessions of one sample (church256, 128 channels): a 48^2 window cut at
4-form metas from a 256^2 map, a 48^2 crop with a swish epilogue and an
edge mask, the same without the epilogue, the tile layout's 192^2 box
crop, a 46^2 paste into a 48^2 map (clamped origins, no coverage), the
same with per-session coverage at a host origin, and the tile layout's
192^2 box paste with coverage. Origins and masks are seeded. For each it
prints, in one JSON line:

  * ``device_ms``: the kernel's busy time per call in a torch.profiler
    trace of CALLS calls (median of REPS traces);
  * ``copy_floor_ms``: the same for one ``torch.Tensor.copy_`` of the
    output's bytes (not the same function: the launch ramp of a copy of
    that size);
  * ``call_ms``: CUDA-event time per call over CALLS back-to-back calls;
  * ``bound_ms``: the bytes the function must move over 3.35 TB/s
    (``chip_smoke.session_kernel_bytes``);
  * ``max_err``: against the plain version (exact; 1e-6 after the
    epilogue, asserted).

GPU only: exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import (PEAK_BYTES_PER_S, SESSION_EPILOGUE_TOL,  # noqa: E402
                        card_line, device_ms, session_kernel_bytes, time_ms)

CALLS = 50
REPS = 3


def cases(S: int, gen):
    """(label, op, args, key, rec) at S sessions: the key and record as
    chip_smoke.py's phase 18 writes them, for the bound."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def mask(*shape, p=0.9):
        return torch.rand(*shape, generator=gen, device="cuda") < p

    rows = torch.tensor([[60 + 30 * s, 90 - 20 * s] for s in range(S)],
                        device="cuda")
    meta = torch.cat([rows.clamp(min=0), torch.zeros_like(rows)], 1)
    meta[0] = torch.tensor([0, 80, 3, 0])  # a window over the top border
    box = torch.tensor([[20 + 8 * s, 40 - 6 * s] for s in range(S)],
                       device="cuda")
    N = S
    yield ("crop 256^2 -> 48^2, 4-form", "crop",
           (rand(N, 256, 256, 128), meta, 48, 48, None, None, None,
            "identity", False, False),
           ("crop", "float32", (N, 256, 256, 128), 48, 48, (S, 4), None,
            None, None, "identity", False, False),
           {"org": meta, "edge": None})
    edge = mask(S, 48, 48)
    yield ("crop 48^2 -> 48^2, swish epilogue, edge", "crop",
           (rand(N, 48, 48, 128), (0, 0), 48, 48, edge, rand(N, 128),
            rand(N, 128), "swish", False, False),
           ("crop", "float32", (N, 48, 48, 128), 48, 48, "host",
            (S, 48, 48), (N, 128), (N, 128), "swish", False, False),
           {"org": (0, 0), "edge": edge})
    yield ("crop 48^2 -> 48^2, edge", "crop",
           (rand(N, 48, 48, 128), (0, 0), 48, 48, edge, None, None,
            "identity", False, False),
           ("crop", "float32", (N, 48, 48, 128), 48, 48, "host",
            (S, 48, 48), None, None, "identity", False, False),
           {"org": (0, 0), "edge": edge})
    yield ("tiles: crop 256^2 -> 192^2 box, clamped", "crop",
           (rand(N, 256, 256, 128), box, 192, 192, None, None, None,
            "identity", False, True),
           ("crop", "float32", (N, 256, 256, 128), 192, 192, (S, 2), None,
            None, None, "identity", False, True),
           {"org": box, "edge": None})
    yield ("paste 46^2 into 48^2, clamped", "paste",
           (rand(N, 48, 48, 128), rand(N, 46, 46, 128), rows // 40, None,
            True),
           ("paste", "float32", "float32", (N, 48, 48, 128),
            (N, 46, 46, 128), (S, 2), None, True),
           {"org": rows // 40, "cov": None})
    cov = mask(S, 46, 46, p=0.7)
    yield ("paste 46^2 into 48^2, per-session cov", "paste",
           (rand(N, 48, 48, 128), rand(N, 46, 46, 128), (1, 1), cov, False),
           ("paste", "float32", "float32", (N, 48, 48, 128),
            (N, 46, 46, 128), "host", (S, 46, 46), False),
           {"org": (1, 1), "cov": cov})
    bcov = mask(S, 192, 192, p=0.7)
    yield ("tiles: paste 192^2 box into 256^2, cov", "paste",
           (rand(N, 256, 256, 128), rand(N, 192, 192, 128), box, bcov,
            True),
           ("paste", "float32", "float32", (N, 256, 256, 128),
            (N, 192, 192, 128), (S, 2), (S, 192, 192), True),
           {"org": box, "cov": bcov})


def median_device_ms(fn):
    return statistics.median(device_ms(fn, iters=CALLS)[0]
                             for _ in range(REPS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree whose sige_torch is measured")
    ap.add_argument("--sessions", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("session_kernel_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("sige_torch")]:
        del sys.modules[name]
    from sige_torch.ops import sessions as ss

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card_line(), "root": os.path.abspath(args.root),
           "module": ss.__file__, "sessions": args.sessions, "rows": []}
    for label, op, a, key, rec in cases(args.sessions, gen):
        kernel, plain = ((ss.crop_sessions, ss.crop_sessions_plain)
                         if op == "crop" else
                         (ss.paste_sessions, ss.paste_sessions_plain))
        out = kernel(*a)
        want = plain(*a)
        err = (out - want).abs().max().item()
        tol = SESSION_EPILOGUE_TOL if op == "crop" and a[7] != "identity" \
            else 0.0
        if not err <= tol:
            raise AssertionError(f"{label}: max err {err:.3e} against the "
                                 f"plain version")
        src = torch.empty_like(out)
        res["rows"].append({
            "label": label, "max_err": err,
            "device_ms": median_device_ms(lambda: kernel(*a)),
            "copy_floor_ms": median_device_ms(lambda: out.copy_(src)),
            "call_ms": time_ms(lambda: kernel(*a), iters=CALLS),
            "bound_ms": session_kernel_bytes(key, rec) / PEAK_BYTES_PER_S
            * 1e3})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
