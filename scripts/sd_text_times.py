"""Phase 14 of ``chip_smoke.py`` alone: SD v1 from a text prompt at full
width. An sd-v1 reference checkpoint (phase 13's, seeded) is written
into a temporary directory and driven through ``cli.sd --prompt
--safety_model`` and ``--embeddings``, beside synthetic CLIP text and
safety-checker snapshots at their published widths (each encoder held
to the port's CPU float64 run), then the U-Net with K/V-cached
transformers and the decoder's tile chain against their defaults, with
every check of the phase. The flash kernel is held against its plain
version at every distinct call of the K/V-cached U-Net's sparse forward
(rows labelled from "z" on).

    python3 scripts/sd_text_times.py

Run it from the root of the repository. It prints the card (name and
power limit) first and the phase's results as one JSON line last. GPU
only: exits non-zero without a CUDA device.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("sd_text_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sige_torch.ops import flash

    t0 = time.perf_counter()
    print(f"card: {chip_smoke.card_line()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    flash.LIBRARY.load()
    with tempfile.TemporaryDirectory(prefix="sige-sd-text-") as tmp:
        ckpt = chip_smoke.checkpoint_sd(flash, tmp, chip_smoke._Seconds())
        result, rows = chip_smoke.phase_sd_text(flash, tmp, set(), 25)
    print(f"elapsed: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"checkpoint_sd": ckpt, "sd_text": result,
                      "rows": rows}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
