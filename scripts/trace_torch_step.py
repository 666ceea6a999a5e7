"""Where the time of one forward goes, on the GPU, in the PyTorch port
(sige_torch): the church256 DDPM U-Net for each layout asked for, the SD
models and the church pd256 PD U-Net.

    python3 scripts/trace_torch_step.py [--layout tiles window auto]
                                        [--sd N] [--pd N] [--gaugan N]
                                        [--demo N]

For each layout in turn (default: ``tiles window window tiles``, one
process, so that drift on the host shows as a difference between the two
runs of one layout) and for the dense and the sparse forward of the
full-width DDPM U-Net (random weights from seed 0, the 1.2% square edit
of ``chip_smoke.py``), then ``--sd`` times (default 0) for the full and
the sparse forward of the SD v1 U-Net at batch 2 (guidance), of the VAE
decoder and of the encoder at 512^2 (the plans and caches that
``chip_smoke.py``'s SD phase leaves: its runner, random text embeddings,
the 512^2 edit, one ``sdedit``), then ``--pd`` times (default 0) for the
full and the sparse forward of the PD U-Net (``PDRunner`` with church
pd256's configs, random weights from seed 0, the DDPM edit, after its
``preprocess``), then ``--gaugan`` times (default 0) for the dense, full
and sparse forward of the Cityscapes SPADE generator (``GauGANRunner``
at 512x256, random weights from seed 0 with the BatchNorm statistics of
``chip_smoke.py``, its synthetic edit, after ``preprocess``), then
``--demo`` times (default 0) for one whole interactive request
(``DemoRunner.generate`` at church256: 25 sparse-only DDIM steps over the
per-step cache slots, after ``reset_base_image``, ``chip_smoke.py``'s
uint8 edit) in the demo's tile layout and in the window layout (each
"forward" below is then one request, over ``DEMO_ITERS`` of them), it
prints, as one JSON line (``runs``, in order):

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
    "sd_decoder", "sd_encoder", "pd", "gaugan" or "demo" (the SD and PD
    runs have a ``full`` and a ``sparse`` entry where the DDPM runs have
    ``dense`` and ``sparse``; the GauGAN runs have all three; the demo
    runs a ``request``).

The script leaves PyTorch's precision flags as they are: the engine runs
its forwards in fp32 with cuDNN's benchmark mode itself. GPU only: exits
non-zero without a CUDA device.
"""

import argparse
import gc
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
DEMO_ITERS = 5  # demo requests (25 forwards each) per measurement
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


def ddpm_run(layout):
    """The DDPM U-Net's dense and sparse forward in ``layout`` over the
    plan and caches of ``DiffusionRunner.preprocess`` on the edit (its
    runner is freed on return, out of the next run's peak)."""
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.runners import DiffusionRunConfig, DiffusionRunner

    cfg = DDPMUNetConfig()
    runner = DiffusionRunner(cfg, DiffusionRunConfig(sampler_type="ddim"),
                             layout=layout, device="cuda", seed=0)
    _, x1, _ = runner.preprocess(*edit_pair(cfg.resolution))
    t = torch.zeros((1,), device="cuda")
    res = {"model": "ddpm", "layout": layout,
           "active_layout": runner.active_layout}
    for mode, fwd in (("dense", runner.model.dense),
                      ("sparse", runner.model.sparse)):
        res[mode] = measure(lambda: fwd(x1, t))
        res[mode]["macs_g"] = runner.count_macs(x1, mode) / 1e9
        res[mode]["peak_mb"] = peak_mb(lambda: fwd(x1, t))
    return res


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


def pd_runs(n):
    """``n`` runs of the PD U-Net's full and sparse forward over the plan
    and caches of ``PDRunner.preprocess`` on the DDPM edit."""
    from sige_torch.models.pd import PDUNetConfig
    from sige_torch.runners import PDRunConfig, PDRunner

    runner = PDRunner(PDUNetConfig(), PDRunConfig(), device="cuda", seed=0)
    x0, x1, _ = runner.preprocess(*edit_pair(runner.model_cfg.resolution))
    ls = runner._cond()
    runs = []
    for _ in range(n):
        res = {"model": "pd", "layout": "auto",
               "active_layout": runner.active_layout}
        for mode, fwd, x in (("full", runner.model.full, x0),
                             ("sparse", runner.model.sparse, x1)):
            res[mode] = measure(lambda: fwd(x, ls))
            res[mode]["macs_g"] = runner.count_macs(x, mode) / 1e9
            res[mode]["peak_mb"] = peak_mb(lambda: fwd(x, ls))
        runs.append(res)
    return runs


def gaugan_runs(n):
    """``n`` runs of the SPADE generator's dense, full and sparse forward
    over the plan and caches of ``GauGANRunner.preprocess`` on
    ``chip_smoke.py``'s synthetic edit."""
    from chip_smoke import calibrate_bn_stats, gaugan_edit_pair
    from sige_torch.models.gaugan import SPADEGenConfig
    from sige_torch.runners import GauGANRunner

    cfg = SPADEGenConfig()
    runner = GauGANRunner(cfg, device="cuda", seed=0)
    s0, s1 = (runner.preprocess_input(lab) for lab in gaugan_edit_pair(cfg))
    calibrate_bn_stats(runner, s0)
    x0, x1, _ = runner.preprocess(s0, s1)
    runs = []
    for _ in range(n):
        res = {"model": "gaugan", "layout": "auto",
               "active_layout": runner.active_layout}
        for mode, x in (("dense", x1), ("full", x0), ("sparse", x1)):
            fwd = getattr(runner.model, mode)
            res[mode] = measure(lambda: fwd(x))
            res[mode]["macs_g"] = runner.count_macs(x, mode) / 1e9
            res[mode]["peak_mb"] = peak_mb(lambda: fwd(x))
        runs.append(res)
    return runs


def demo_runs(n):
    """``n`` runs of one demo request in the tile layout (the demo's) and
    in the window layout, each runner reset on the same base."""
    from chip_smoke import quantized
    from sige_torch.demo import DemoRunner
    from sige_torch.models.ddpm import DDPMUNetConfig

    base, edited = (quantized(a) for a in edit_pair(256))
    runs = []
    for layout in ("tiles", "window"):
        runner = DemoRunner(DDPMUNetConfig(), bucket_min=8, layout=layout,
                            device="cuda")
        runner.reset_base_image(base)
        def request():
            return runner.generate(edited)

        for _ in range(n):
            res = {"model": "demo", "layout": layout,
                   "request": measure(request, iters=DEMO_ITERS)}
            res["active_layout"] = runner.model.active_layout
            res["request"]["peak_mb"] = peak_mb(request)
            runs.append(res)
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", nargs="*",
                    default=["tiles", "window", "window", "tiles"],
                    choices=["tiles", "window", "auto"])
    ap.add_argument("--sd", type=int, default=0,
                    help="runs of the SD models' full and sparse forward")
    ap.add_argument("--pd", type=int, default=0,
                    help="runs of the PD U-Net's full and sparse forward")
    ap.add_argument("--gaugan", type=int, default=0,
                    help="runs of the SPADE generator's dense, full and "
                         "sparse forward")
    ap.add_argument("--demo", type=int, default=0,
                    help="runs of one demo request per layout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_torch_step: no CUDA device", file=sys.stderr)
        return 1
    out = {"card": card_line(), "iters": ITERS,
           "runs": [ddpm_run(layout) for layout in args.layout]}
    if args.sd:
        out["runs"] += sd_runs(args.sd)
    gc.collect()  # every earlier run's models out of the PD runs' peak
    torch.cuda.empty_cache()
    if args.pd:
        out["runs"] += pd_runs(args.pd)
    gc.collect()
    torch.cuda.empty_cache()
    if args.gaugan:
        out["runs"] += gaugan_runs(args.gaugan)
    gc.collect()
    torch.cuda.empty_cache()
    if args.demo:
        out["runs"] += demo_runs(args.demo)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
