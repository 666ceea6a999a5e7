"""Where the time of one forward goes, on the GPU, in the PyTorch port
(sige_torch): the church256 DDPM U-Net for each layout asked for, and
the SD U-Net.

    python3 scripts/trace_torch_step.py [--layout tiles window auto]
                                        [--sd N]

For each layout in turn (default: ``tiles window window tiles``, one
process, so that drift on the host shows as a difference between the two
runs of one layout) and for the dense and the sparse forward of the
full-width DDPM U-Net (random weights from seed 0, the 1.2% square edit
of ``chip_smoke.py``), then ``--sd`` times (default 0) for the full and
the sparse forward of the SD v1 U-Net at batch 2 (guidance), of the VAE
decoder and of the encoder at 512^2 (the plans and caches that
``chip_smoke.py``'s SD phase leaves: its runner, random text embeddings,
the 512^2 edit, one ``sdedit``), it prints, as one JSON line
(``runs``, in order):

  * ``device_ms``: median time between two CUDA events around a forward;
  * ``host_ms``: median host time to enqueue a forward (no sync) — when it
    is close to ``device_ms`` the host bounds the step;
  * ``busy_ms_per_forward``: the device time of all kernels in a
    ``torch.profiler`` trace of 20 forwards, per forward;
  * ``idle_share``: 1 - busy / device_ms, the share of an (unprofiled)
    forward in which no kernel runs (the profiler's own host overhead
    inflates its traced wall time, ``traced_wall_ms_per_forward``);
  * ``launches``: kernels launched per forward; ``top``: the kernels with
    the most device time per forward; ``flash_ms_per_forward`` and
    ``flash_launches_per_forward``: every kernel of
    ``sige_torch/csrc/flash_attn.cu`` (attention and split combine);
    ``cat_ms_per_forward`` and ``cat_launches_per_forward``: PyTorch's
    concatenation kernels (the masked stale/fresh attention's K/V and
    bias joins, the U-Net's skip joins);
  * ``macs_g``: the forward's analytic GMACs; ``peak_mb``: the peak device
    memory allocated by one forward (params and caches resident);
  * per run, ``layout`` as asked and ``active_layout``, what the planner
    ran (``auto`` resolves per edit), and ``model``: "ddpm", "sd_unet",
    "sd_decoder" or "sd_encoder" (the SD runs have a ``full`` and a
    ``sparse`` entry where the DDPM runs have ``dense`` and ``sparse``).

``--cudnn-benchmark`` lets cuDNN time its algorithms for each conv shape
(off by default, as in the port).

TF32 is off for matmuls and cuDNN convs (the port's fp32 contract). GPU
only: exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (FLASH_KERNELS, _dev_time, card_line,  # noqa: E402
                        edit_pair)

ITERS = 20  # forwards per measurement
TOP = 12    # kernels listed per mode


def peak_mb(call) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def measure(call, iters=ITERS, top=TOP):
    """The numbers above for ``call`` (one forward)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        h0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - h0) * 1e3)
        e.record()
        torch.cuda.synchronize()
        dev.append(s.elapsed_time(e))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _dev_time(e) > 0]
    busy_ms = sum(_dev_time(e) for e in kernels) / 1e3 / iters
    kernels.sort(key=_dev_time, reverse=True)
    flash = [e for e in kernels if any(n in e.key for n in FLASH_KERNELS)]
    flash_ms = sum(_dev_time(e) for e in flash)
    cat = [e for e in kernels if "CatArray" in e.key]
    device_ms = statistics.median(dev)
    return {
        "device_ms": device_ms,
        "host_ms": statistics.median(host),
        "traced_wall_ms_per_forward": wall_ms / iters,
        "busy_ms_per_forward": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / device_ms),
        "launches_per_forward": sum(e.count for e in kernels) / iters,
        "flash_ms_per_forward": flash_ms / 1e3 / iters,
        "flash_launches_per_forward": sum(e.count for e in flash) / iters,
        "cat_ms_per_forward": sum(_dev_time(e) for e in cat) / 1e3 / iters,
        "cat_launches_per_forward": sum(e.count for e in cat) / iters,
        "top": [{"kernel": e.key[:90], "ms_per_forward":
                 _dev_time(e) / 1e3 / iters,
                 "calls_per_forward": e.count / iters}
                for e in kernels[:top]],
    }


def sd_runs(n):
    """``n`` runs of the full and sparse forward of the SD U-Net, decoder
    and encoder over the plans and caches of one ``sdedit`` of
    ``chip_smoke.py``'s SD phase."""
    from chip_smoke import SD_GUIDANCE, SD_STEPS, SD_STRENGTH
    from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
    from sige_torch.nn.module import SIGECtx
    from sige_torch.runners import SDRunConfig, SDRunner

    runner = SDRunner(SDUNetConfig(), SDVAEConfig(resolution=512),
                      SDRunConfig(ddim_steps=SD_STEPS, strength=SD_STRENGTH,
                                  guidance_scale=SD_GUIDANCE),
                      seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    uc, c = (torch.randn(1, 77, 768, generator=gen, device="cuda")
             for _ in range(2))
    original, edited = edit_pair(512)
    x0, x1 = (runner._image(2 * a - 1) for a in (original, edited))
    runner.sdedit(2 * original - 1, 2 * edited - 1, uc=uc, c=c, seed=0)
    z0, z1 = runner.encode(x0), runner.encode(x1, mode="sparse")
    t, ctx = torch.full((2,), 501.0, device="cuda"), torch.cat([uc, c])
    # (full-mode input: the original, sparse-mode input: the edit)
    models = {"sd_unet": (runner.unet, (torch.cat([z0, z0]), t, ctx),
                          (torch.cat([z1, z1]), t, ctx)),
              "sd_decoder": (runner.decoder, (runner._pre_decode(z0),),
                             (runner._pre_decode(z1),)),
              "sd_encoder": (runner.encoder, (x0,), (x1,))}
    runs = []
    for _ in range(n):
        for name, (model, a0, a1) in models.items():
            res = {"model": name, "layout": "window",
                   "active_layout": model.active_layout}
            for mode, fwd, a in (("full", model.full, a0),
                                 ("sparse", model.sparse, a1)):
                res[mode] = measure(lambda: fwd(*a))
                mc = SIGECtx(mode=mode, macs=[])
                with torch.inference_mode():
                    model.module(*a, ctx=mc)
                res[mode]["macs_g"] = sum(mc.macs) / 1e9
                res[mode]["peak_mb"] = peak_mb(lambda: fwd(*a))
            runs.append(res)
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", nargs="*",
                    default=["tiles", "window", "window", "tiles"],
                    choices=["tiles", "window", "auto"])
    ap.add_argument("--sd", type=int, default=0,
                    help="runs of the SD models' full and sparse forward")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="let cuDNN time its algorithms per conv shape "
                         "(torch.backends.cudnn.benchmark)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_torch_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.runners import DiffusionRunConfig, DiffusionRunner

    card = card_line()
    cfg = DDPMUNetConfig()
    original, edited = edit_pair(cfg.resolution)
    t = torch.zeros((1,), device="cuda")
    out = {"card": card, "iters": ITERS,
           "cudnn_benchmark": args.cudnn_benchmark, "runs": []}
    for layout in args.layout:
        runner = DiffusionRunner(cfg, DiffusionRunConfig(sampler_type="ddim"),
                                 layout=layout, device="cuda", seed=0)
        _, x1, _ = runner.preprocess(original, edited)
        res = {"model": "ddpm", "layout": layout,
               "active_layout": runner.active_layout}
        for mode, fwd in (("dense", runner.model.dense),
                          ("sparse", runner.model.sparse)):
            res[mode] = measure(lambda: fwd(x1, t))
            res[mode]["macs_g"] = runner.count_macs(x1, mode) / 1e9
            res[mode]["peak_mb"] = peak_mb(lambda: fwd(x1, t))
        out["runs"].append(res)
        del runner
        torch.cuda.empty_cache()
    if args.sd:
        out["runs"] += sd_runs(args.sd)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
