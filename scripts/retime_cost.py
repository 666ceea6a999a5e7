"""What cuDNN's benchmark mode costs per new edit in the PyTorch port, for
one setting of ``torch.backends.cudnn.benchmark_limit`` (how many of
cuDNN's algorithms benchmark mode times for each new conv shape;
PyTorch's default is 10).

    python3 scripts/retime_cost.py [--limit N]

The engine runs every forward in benchmark mode, and cuDNN keeps what it
timed for the life of the process, so run one process per setting. The
script times, in this order, with the host clock around each call
(synchronised):

  * the church256 DDPM main path (``DiffusionRunner``, layout auto, DDIM,
    5 steps from noise level 500): ``generate`` on the edit of
    ``chip_smoke.py``, again, on its second edit (other window shapes at
    every level), again;
  * the SD path of ``chip_smoke.py`` (``SDRunner`` at 512^2, guidance
    7.5, 10 DDIM steps at strength 0.5): ``sdedit`` on the same two edits
    in the same order; then the decoder's full and sparse forward over
    the last edit's plan (median of 20 between CUDA events, and the peak
    MB of one).

Prints one JSON line. GPU only: exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (SD_GUIDANCE, SD_STEPS, SD_STRENGTH,  # noqa: E402
                        STEPS, card_line, edit_pair, events_ms, second_edit,
                        timed_calls)

EDITS = ("a_first", "a_again", "b_first", "b_again")


def edits(R):
    a, b = edit_pair(R), second_edit(R)
    return dict(zip(EDITS, (a, a, b, b)))


def ddpm():
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.runners import DiffusionRunConfig, DiffusionRunner

    cfg = DDPMUNetConfig()
    runner = DiffusionRunner(cfg, DiffusionRunConfig(
        sampler_type="ddim", eta=0.0, sample_steps=STEPS, noise_level=500),
        device="cuda", seed=0)
    return timed_calls([(k, lambda e=e: runner.generate(*e, seed=0))
                        for k, e in edits(cfg.resolution).items()])


def sd():
    from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
    from sige_torch.runners import SDRunConfig, SDRunner

    runner = SDRunner(SDUNetConfig(), SDVAEConfig(resolution=512),
                      SDRunConfig(ddim_steps=SD_STEPS, strength=SD_STRENGTH,
                                  guidance_scale=SD_GUIDANCE),
                      seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    uc, c = (torch.randn(1, 77, 768, generator=gen, device="cuda")
             for _ in range(2))
    pairs = {k: [2.0 * a - 1.0 for a in e]
             for k, e in edits(runner.vae_cfg.resolution).items()}
    out = {"sdedit_s": timed_calls(
        [(k, lambda e=e: runner.sdedit(*e, uc=uc, c=c, seed=0))
         for k, e in pairs.items()])}
    x0, x1 = (runner._image(a) for a in pairs["b_again"])
    z0, z1 = runner.encode(x0), runner.encode(x1, mode="sparse")
    for mode, fwd, z in (("full", runner.decoder.full, z0),
                         ("sparse", runner.decoder.sparse, z1)):
        arg = runner._pre_decode(z)
        fwd(arg)
        median, _ = events_ms(lambda: fwd(arg), 20)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd(arg)
        torch.cuda.synchronize()
        out[f"decoder_{mode}"] = {
            "ms": median, "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--limit", type=int, default=None,
                    help="torch.backends.cudnn.benchmark_limit (default: "
                         "PyTorch's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("retime_cost: no CUDA device", file=sys.stderr)
        return 1
    if args.limit is not None:
        torch.backends.cudnn.benchmark_limit = args.limit
    from sige_torch.ops import flash

    flash.LIBRARY.load()  # the kernel build out of the first edit's time
    print(json.dumps({"card": card_line(),
                      "benchmark_limit": torch.backends.cudnn.benchmark_limit,
                      "ddpm_generate_s": ddpm(), "sd": sd()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
