"""Phase 15 of ``chip_smoke.py`` alone: the engine's options at full
width. ``cache_dtype`` on the church256 DDPM U-Net with the demo's 25
slots (MiB per slot, the bf16 sessions the card holds, the sparse
forward's median and launches against fp32 caches, the contract of
narrow storage), cache slots and ``sparse_update`` on the PD U-Net, the
SD U-Net, encoder and decoder and the GauGAN generators (fused and
sub-mobile), and ``pin_capacities`` / ``merge_pins`` in the tile layout,
with every check of the phase. The flash kernel is held against its
plain version at every call shape of the phase (rows labelled from "ab"
on; inside ``chip_smoke.py`` only the shapes no earlier phase held).

    python3 scripts/engine_option_times.py

Run it from the root of the repository. It prints the card (name and
power limit) first and the phase's results as one JSON line last. GPU
only: exits non-zero without a CUDA device.
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
        print("engine_option_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sige_torch.ops import flash

    t0 = time.perf_counter()
    print(f"card: {chip_smoke.card_line()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    flash.LIBRARY.load()
    result, rows = chip_smoke.phase_engine_options(flash, set(), 27)
    print(f"elapsed: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"options": result, "rows": rows}, default=str),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
