"""Phase 13 of ``chip_smoke.py`` alone: reference-layout checkpoints of
every family at full width (DDPM church256 vanilla, PD pd256, GauGAN
fused, plain SPADE and sub-mobile, SD v1 at 512^2) written as .pth files,
read, converted, saved and loaded natively and driven through the port's
command lines, each step timed on the host clock (synchronised) on its
own line, with every check of the phase.

    python3 scripts/checkpoint_times.py

Run it from the root of the repository (the command lines read
``configs/``). It prints the card (name and power limit) first and the
phase's results as one JSON line last. GPU only: exits non-zero without a
CUDA device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("checkpoint_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sige_torch.ops import flash

    t0 = time.perf_counter()
    print(f"card: {chip_smoke.card_line()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    flash.LIBRARY.load()
    result = chip_smoke.phase_checkpoints(flash)
    print(f"elapsed: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
