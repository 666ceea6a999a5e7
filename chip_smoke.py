"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase {checkpoints,sd_text,engine_options,quality}

With ``--phase`` it builds the kernels and runs that phase alone (13, 14
with phase 13's SD checkpoint, 15 or 16), printing the card first and
the phase's record as one JSON line last.

Phases (any failure raises and the script exits non-zero):

1. card   — the card's name and power limit (nvidia-smi); exits non-zero
            without a CUDA device;
2. build  — compiles every CUDA kernel of the port from ``sige_torch/csrc``
            with nvcc for sm_90a (into ``build/sige_torch/``), all at once;
3. kernels — holds each kernel against its plain PyTorch version at the
            main path's shapes and at synthetic SD shapes (a)-(e) (inside
            the engine's fp32 scope, so the plain versions are true fp32),
            and times the
            kernel, the plain version and one library call that computes
            the same function (a yardstick only; the port never calls it):
            ``ms`` is CUDA-event time over back-to-back calls (what a
            caller feels: the host's enqueue bounds it when it is slower
            than the device); ``device_ms`` is the kernels' busy time per
            call in a torch.profiler trace.
            The attention kernel splits the key range when the query
            blocks leave SMs idle (split-KV) and the combine kernel merges
            the splits: each shape prints its split count S; at the main
            path's shape (a) the kernels also run with S forced to 1 and
            to the most tiles, and the split path is held against its
            plain version (partials per key range, plain combine);
4. small  — a tiny DDPM U-Net on the card agrees with the same U-Net on
            the CPU, in the tile layout and in the window layout with
            chains, and so does a tiny PD U-Net (window layout); the
            first forward prints cuDNN's benchmark limit inside it (the
            engine's ``BENCHMARK_LIMIT``);
5. retime — what cuDNN's benchmark mode (which the engine sets, as the
            reference does, timing ``BENCHMARK_LIMIT`` algorithms per new
            conv shape) costs per new edit: the DDPM main path's
            ``generate`` on a first edit, again, on a second edit with
            other window shapes, again; then the full and sparse forwards
            through the engine against the same module called with
            benchmark mode off (cuDNN's heuristic), in turns;
6. paths  — the church256 DDPM SDEdit path at full width through
            ``sige_torch.runners.DiffusionRunner``, three times:
            * ``main``: the runner's default, ``layout="auto"``, which
              resolves to the window layout (with chains) on this edit,
              DDIM eta 0, 5 steps from noise level 500;
            * ``tiles``: the same with ``layout="tiles"``;
            * ``dpm_solver``: the main path's layout with DPM-Solver++
              (configs/church_dpmsolver256-sige.yml: order 2, 5 steps,
              noise level 500).
            Each asserts the layout it ran; for the two DDIM paths the
            sparse pass on the original image equals the full pass
            (< 1e-4), again after a sparse pass on the edited image (a
            join that wrote into its cache would show there), and
            ``profile`` times dense and sparse forwards (median, p90,
            GMACs, peak MB). ``generate`` runs with the launch counters
            (attention and combine kernels) set to 0 just before and read
            just after, each held to its exact expected count;
7. sd     — the Stable Diffusion SDEdit path at full width through
            ``sige_torch.runners.SDRunner`` (SD v1 U-Net with guidance 7.5
            at batch 2, the VAE at 512^2, 5 twin steps): ``sdedit`` with
            the launch counters set to 0 just before and read just after,
            held to the count derived from the config and the plans;
            sparse = full on the original for the encoder, U-Net and
            decoder, also after a sparse pass on the edit; per model and
            mode the launches, latency, GMACs and peak MB (the decoder's
            sparse forward held below its full one, with a peak under
            10 GB); ``sdedit`` again, and
            twice on a second edit with other window shapes;
8. sd kernels — the flash kernel against its plain version at every
            distinct (B, N, M, H, D) the SD path's forwards give it, the
            masked rows with the biases the models built from their plans:
            (f) the decoder's mid attention, (g) its masked stale/fresh
            form, (h) the encoder's masked form, then each U-Net self-,
            cross- and masked self-attention;
9. pd     — the Progressive Distillation SDEdit path at full width
            through ``sige_torch.runners.PDRunner`` (church pd256: 8
            total steps, 5 sample steps from noise level 5, the DDPM
            paths' edit): the layout ``auto`` ran (window), sparse = full
            on the original, also after a sparse pass on the edit,
            ``generate`` with the launch counters set to 0 just before and
            read just after, held to the count derived from the config;
            dense, full and sparse forwards: launches, latency, GMACs,
            peak MB;
10. pd kernels — the flash kernel against its plain version at every
            distinct call of the PD U-Net (multi-head, D = 64);
11. gaugan — the GauGAN semantic-editing path at full width through
            ``sige_torch.runners.GauGANRunner``: the Cityscapes SPADE
            generator (``SPADEGenConfig()``, 93.07 M, 512x256, BatchNorm
            statistics calibrated on the original), the synthetic edit of
            ``sige_tpu/cli/gaugan.py``: ``generate`` with the launch
            counters set to 0 just before and read just after, held to 0
            (GauGAN has no attention), the layout ``auto`` ran (window);
            ``generate`` again, on a second edit, again; sparse = full on
            the original, also after a sparse pass on the edit; sparse
            against dense on the edit (printed: approximate by design);
            dense, full and sparse forwards (flash launches, latency,
            GMACs with the dense count held to sige_tpu's 281.3, peak MB,
            kernel launches); the tile layout once; the GAN-Compression
            sub-mobile generator (20.19 M) on the same edit;
12. demo  — the interactive editing path at church256 full width
            (``sige_torch.demo``, the earlier phases' models freed first):
            ``DemoRunner`` (25 steps from noise level 400, 25 cache
            slots, the tile layout, ``bucket_min`` 8) with DDIM and with
            DPM-Solver++: reset, generate on the DDPM paths' edit, the
            sparse-only trajectory of the unedited base under that plan
            (= the reset, < 1e-4), apply (= generate), the sparse-only
            repeat over the applied caches (= generate), the 3% second
            edit; each request's flash launches (counters set to 0 just
            before, read just after) held to 6 + 6 per forward, its host
            seconds, resident and peak MB, the caches' MB per slot; then
            the HTTP server in-process (each response's PNG equals the
            direct run's output after the server's uint8 conversion),
            ``MultiSessionDemoRunner`` at S = 2 and 4 (each session equals
            an independent runner; session 0's apply leaves session 1's
            tensors as they were) and ``SessionServer`` (window layout,
            S = 4: the step on the originals equals the dense forward,
            ``sparse_update`` equals the step);
13. checkpoints and command lines — reference-layout state dicts at full
            width (keys and shapes from :func:`reference_layout`, which
            names the port's keys as the reference does; values from
            seeds), each written as a .pth, read, converted, saved and
            loaded natively (every step timed on its own line) and driven
            through the port's command line in-process:
            * DDPM church256 from a *vanilla* checkpoint through
              ``cli.diffusion`` (``model.network=ddpm.unet``: the fuse
              surgery; DDIM, 5 steps) in profile and generate mode: the
              fused dense forward equals ``VanillaDDPMUNet`` on the
              unfused conversion, sparse = full, 6 + 6 flash launches per
              forward and the CLI runs' counts, the log lines, and
              ``--save_converted`` then ``--restore_from`` of that
              directory gives the same weights, output and PNG bit for
              bit;
            * PD church pd256 through ``cli.diffusion`` with
              ``configs/church_pd256-sige.yml`` (22 + 22 per forward,
              242 + 242 per generate);
            * GauGAN at 512x256 through ``cli.gaugan``: a fused
              checkpoint, a plain SPADE checkpoint (the fusing surgery)
              and a fused sub-mobile one (statistics at nominal width),
              BatchNorm statistics calibrated through the port's own
              conversion; 0 flash launches, sparse = full;
            * SD v1 at 512^2 through ``cli.sd --task sdedit --synthetic
              --embeddings`` (U-Net, VAE, ``quant_conv`` folded,
              ``post_quant_conv``; 5 twin steps): the sdedit's flash
              launches, 32 per U-Net and 1 per VAE forward (and a
              combine launch for each split call), sparse = full; the
              checkpoint stays for phase 14;
14. sd text path and options — in phase 13's temporary directory:
            (a) synthetic snapshots at the published widths: CLIP text
            (768 hidden, 12 layers, 12 heads, 3072 MLP, 77 positions,
            49 408 tokens: the 256 byte symbols, their ``</w>`` forms,
            seeded merges, the two specials) in the hub-cache layout that
            ``HF_HUB_CACHE`` points at, and the safety checker (ViT-L/14
            at 224, a 768 projection, 17 concept and 3 special-care
            embeddings) with a seeded threshold that a smooth image trips
            and the synthetic init image does not;
            (b) the card's ``encode_prompts(["", p])`` and pooled vision
            features against the port's CPU float64 run (within 1e-4 *
            max(1, max|ref|)), the verdicts, ms per forward on CUDA
            events;
            (c) ``cli.sd --task sdedit --synthetic --prompt ...
            --safety_model ...`` over the SD checkpoint, then the same
            with ``--embeddings`` of (b)'s (uc, c): byte-identical PNGs,
            both times, the flash launches held to the sdedit's count,
            the safety verdict;
            (d) the U-Net with ``kv_cache_min_tokens=1024`` (the 64^2 and
            32^2 levels take the K/V caches): sparse(x0) = full(x0), also
            after a sparse(x1), within 1e-4 * max(1, max|full|); flash
            launches per forward held to the count of the K/V-cached
            mode; full and sparse medians, launches and idle shares
            beside the default window chain's; the kernel against its
            plain version at every new flash shape (rows from (z) on);
            (e) the decoder at 512^2 in the tile layout with and without
            ``tile_chain``: sparse(x0) = full(x0) in both, chained =
            unchained on one edit and plan, the sparse medians, launches
            and idle shares beside the window layout's; the phase's peak
            device memory;
15. engine options — at full width, random weights from seeds:
            (a) ``cache_dtype`` on the church256 DDPM U-Net with the
            demo's 25 slots: MiB per slot at fp32 and bf16, as many bf16
            sessions of 25 filled slots as the card holds (2 GiB kept
            free) and their peak, the sparse forward's median and
            launches with bf16 caches against fp32 ones on the DDPM
            paths' edit in the window and tile layouts, and the contract:
            bf16 storage = fp32 storage of the same rounded values
            (within 1e-5 * max(1, max|out|));
            (b) two cache slots and ``sparse_update`` on ``PDUNetConfig()``,
            ``SDUNetConfig()`` (latent 64^2, batch 2), the SD encoder and
            decoder at 512^2 (window layout), and one slot on GauGAN
            fused and sub-mobile at 512x256: full passes, a commit into
            the last slot (no other slot's tensor touched), a second edit
            over it, slot 0's sparse(x0) = full(x0) (one slot: the commit
            replays under its plan); every forward's flash launches held
            to the count of its mode (the chains step aside for the
            commit); the kernel against its plain version at every new
            call shape;
            (c) ``pin_capacities`` in the tile layout on DDPM: smaller
            edits keep the pinned shapes, a new edit's cost (first call
            minus its repeat) with pins and without, pinned = unpinned
            output, and ``merge_pins`` over two sessions' plans feeding
            one ``set_masks`` each;
16. quality path — at the backbones' published widths, synthetic
            weights from seeds written in the published checkpoints'
            layouts (:func:`metric_weights`) into a temporary directory:
            (a) AlexNet's LPIPS taps on a 256^2 pair, ``FIDInception`` on
            16 images of 256^2 and 8 of 512^2 (resized to 299) and
            ``DRNSeg`` at 512x256 on the card against the port's CPU
            float64 run of the same module (within 1e-4 * max(1,
            max|ref|); the LPIPS distance within 1e-5 and the FID within
            1e-3 relative; the DRN labels equal away from near-ties), and
            each backbone run under TF32 outside the fp32 scope has to
            miss that limit (a control: the limit sees the precision); ms
            per forward on CUDA events, GMACs, launches, peak MB;
            (c) ``cli.golden --family ddpm`` at church256 (a reference
            fused checkpoint over a ``file://`` mirror with its md5 in the
            registry spec, a 2-image SDEdit dataset, PSNR, LPIPS and FID):
            the md5-verified fetch, the files, the scored list, the flash
            launches of its two generates held exactly;
            (b) ``cli.get_metric`` on the card over (c)'s images against
            their originals (PSNR with masks, LPIPS, FID, mIoU through the
            DRN), each held to an in-process ``--device cpu`` run: PSNR
            and mIoU lines equal, LPIPS within 1e-4, FID within 1e-3
            relative.

Phases 6, 7, 9 and 11 also time ``SIGEModel.set_masks`` (host planning
and the plan's upload) per family on its edit, median of 10 on the host
clock, beside the sparse forward's median.

The paths (phases 4-7, 9 and 11-16) run under PyTorch's default precision flags,
which run cuDNN convs in TF32: the engine holds fp32 and benchmark mode
for its own forwards, and the script checks that the flags are the
defaults again at its end. The kernel phases enter the same scope.

The line before the last is the ``kernels`` JSON; the last line is the
device JSON.
"""

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sige_torch.nn.engine import (fp32_scope, precision_flags,
                                  set_precision_flags)

# H100 SXM published peaks: fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-4
FLASH_SOURCE = "sige_torch/csrc/flash_attn.cu"
FLASH_REPLACES = "sige_tpu/ops/flash.py:48"  # _fwd_kernel (pallas_call :99)
FLASH_KERNELS = ["flash_fwd_f32", "flash_combine_f32"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _dev_time(e):
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def device_ms(fn, iters: int = 20, tries: int = 3, required: bool = True):
    """Device kernel time of one call of ``fn``: the summed busy time of
    its kernels in a torch.profiler trace of ``iters`` calls, per call;
    returns (total ms, {kernel name: ms}). Now and then a trace holds no
    device activity at all; it is then taken again, up to ``tries``
    times, and then raises, or with ``required`` False returns (None,
    {}): not measured."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {e.key: _dev_time(e) / 1e3 / iters
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _dev_time(e) > 0}
        if per:
            return sum(per.values()), per
    if required:
        raise AssertionError(f"the profiler recorded no device time in "
                             f"{tries} traces")
    print(f"  (the profiler recorded no device time in {tries} traces: "
          f"device ms not measured)", flush=True)
    return None, {}


def time_ms(fn, warmup: int = 5, iters: int = 20) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls
    between two CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, N, M, H, D, bias: bool):
    """Least time for one attention call: bytes (q, k, v, bias read once,
    out written once) over HBM bandwidth vs 4*N*M*D flops per head over
    the fp32 rate."""
    nbytes = 4 * (2 * B * N * H * D + 2 * B * M * H * D + (M if bias else 0))
    flops = 4.0 * B * H * N * M * D
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(flash):
    """Hold the flash kernel against its plain twin at shapes (a)-(e)."""

    def live_bias(M, dead):
        b = torch.zeros(M, device="cuda")
        b[dead] = -1e9
        return b

    # (label, B, N, M, H, D, bias)
    shapes = []
    shapes.append(("a: DDPM 16px attention", 1, 256, 256, 1, 512, None))
    shapes.append(("b: DDPM 8px mid attention", 1, 64, 64, 1, 512, None))
    shapes.append(("c: SD 64x64 self-attention", 2, 4096, 4096, 8, 40, None))
    dead77 = torch.randperm(77, generator=torch.Generator().manual_seed(1))[:8]
    shapes.append(("d: ragged text KV M=77 with bias", 2, 1024, 77, 8, 80,
                   live_bias(77, dead77.cuda())))
    # (e) masked stale/fresh form: each of the 1024 fresh positions kills
    # its stale copy, so exactly one copy of every position is live
    Ms, Mf = 4096, 1024
    stale_dead = torch.randperm(Ms, generator=torch.Generator().manual_seed(2))
    bias_e = torch.cat([live_bias(Ms, stale_dead[:Mf].cuda()),
                        torch.zeros(Mf, device="cuda")])
    shapes.append(("e: masked stale/fresh K/V (SD)", 2, 1024, Ms + Mf, 8, 40,
                   bias_e))

    return [kernel_row(flash, *shape) for shape in shapes]


def kernel_row(flash, label, B, N, M, H, D, bias):
    """Hold the flash kernel against its plain twin at one shape (random
    q, k, v) and time it, the plain version and SDPA."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(N + M + D)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    scale = D ** -0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = flash._num_splits(B * H, N, M, D, sms)
    out = flash.flash_mha(q, k, v, scale, bias)
    torch.cuda.synchronize()
    ref = flash.flash_mha_plain(q, k, v, scale, bias)
    err = (out - ref).abs().max().item()
    if not (err <= TOL):
        raise AssertionError(f"{label}: kernel vs plain max err {err:.3e}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fns = {"kernel": lambda: flash.flash_mha(q, k, v, scale, bias),
           "plain": lambda: flash.flash_mha_plain(q, k, v, scale, bias),
           "library": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=bias, scale=scale)}
    call = {n: time_ms(fn) for n, fn in fns.items()}
    dev = {n: device_ms(fn, required=False)[0] for n, fn in fns.items()}
    bound_ms, bound_by = attention_bound(B, N, M, H, D, bias is not None)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    print(f"  {label}: S={splits}  max err {err:.3e}  ms (events): "
          f"kernel {call['kernel']:.4f}  plain {call['plain']:.4f}  sdpa "
          f"{call['library']:.4f}  bound {bound_ms:.5f} ({bound_by}); "
          f"device ms (profiler): kernel {fmt(dev['kernel'])}  plain "
          f"{fmt(dev['plain'])}  sdpa {fmt(dev['library'])}", flush=True)
    return {"shape": label, "B": B, "N": N, "M": M, "H": H, "D": D,
            "bias": bias is not None, "splits": splits,
            "max_err": err, "kernel_ms": call["kernel"],
            "plain_ms": call["plain"], "library_ms": call["library"],
            "kernel_device_ms": dev["kernel"],
            "plain_device_ms": dev["plain"],
            "library_device_ms": dev["library"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_forced_splits(flash):
    """Shape (a) through the wrapper's internal launch with S forced to 1,
    to the wrapper's choice and to one split per tile, each held against
    the plain version and, split, against the plain split path; the
    combine kernel's own device time is read from the chosen S's trace."""
    B, N, M, H, D = 1, 256, 256, 1, 512
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    scale = D ** -0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = flash._num_splits(B * H, N, M, D, sms)
    tiles = -(-M // flash.BLOCK_K)
    ref = flash.flash_mha_plain(q, k, v, scale)
    forced = {}
    for splits in sorted({1, chosen, tiles}):
        out = flash._launch(q, k, v, scale, None, splits)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        split_ref = flash.flash_mha_plain_split(q, k, v, scale, None, splits)
        split_err = (out - split_ref).abs().max().item()
        if not (err <= TOL and split_err <= TOL):
            raise AssertionError(f"(a) with S={splits}: max err {err:.3e} "
                                 f"vs plain, {split_err:.3e} vs plain split")
        ms, per = device_ms(
            lambda: flash._launch(q, k, v, scale, None, splits))
        forced[splits] = {"max_err": err, "max_err_vs_plain_split": split_err,
                          "device_ms": ms, "by_kernel": per}
        print(f"  (a) S={splits}{' (chosen)' if splits == chosen else ''}: "
              f"max err {err:.3e} (plain), {split_err:.3e} (plain split)  "
              f"device {ms:.4f} ms: " + ", ".join(
                  f"{name.split('(')[0][-40:]} {t:.4f}"
                  for name, t in per.items()), flush=True)
    ms = sum(t for name, t in forced[chosen]["by_kernel"].items()
             if "flash_combine_f32" in name)
    parts = flash.flash_partials_plain(q, k, v, scale, None, chosen)
    plain_ms = device_ms(lambda: flash.flash_combine_plain(*parts))[0]
    # bytes: partials read once, output written once
    nbytes = 4 * (chosen * B * H * N * (D + 2) + B * N * H * D)
    combine = {"splits": chosen, "device_ms": ms, "plain_device_ms": plain_ms,
               "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    print(f"  combine kernel at (a), S={chosen}: device ms {ms:.4f}  plain "
          f"{plain_ms:.4f}  bound {combine['bound_ms']:.5f} (bytes)",
          flush=True)
    return forced, combine


def edit_pair(R: int, frac: float = 0.012, at=None):
    """The ``__graft_entry__._build`` edit: a square of ``frac`` (~1.2%) of
    the canvas at ``at`` (default (R/4, R/4)) over a random image, both
    from default_rng(0)."""
    rng = np.random.default_rng(0)
    original = rng.random((R, R, 3)).astype(np.float32)
    edited = original.copy()
    side = max(4, int(round((frac * R * R) ** 0.5)))
    r, c = at or (R // 4, R // 4)
    edited[r: r + side, c: c + side] = rng.random((side, side, 3))
    return original, edited


def second_edit(R: int):
    """A second edit whose windows differ in shape from
    :func:`edit_pair`'s at every level: a 3% square at (R/2, 3R/8)."""
    return edit_pair(R, frac=0.03, at=(R // 2, 3 * R // 8))


def gaugan_edit_pair(cfg, frac: float = 0.012, at=None):
    """``sige_tpu/cli/gaugan.py``'s synthetic pair at ``SPADEGenConfig``
    ``cfg``: [H, W] labels uniform over the classes but the last, from
    default_rng(0), and the same labels with a square of ``frac`` (~1.2%)
    of the canvas set to the last class at ``at`` (default (H/3, W/3))."""
    rng = np.random.default_rng(0)
    H, W = round(cfg.crop_size / cfg.aspect_ratio), cfg.crop_size
    n = cfg.semantic_nc - 1  # label classes; the last channel is the edges
    original = rng.integers(0, n - 1, (H, W))
    edited = original.copy()
    side = max(4, int(round((frac * H * W) ** 0.5)))
    r, c = at or (H // 3, W // 3)
    edited[r: r + side, c: c + side] = n - 1
    return original, edited


def gaugan_second_edit(cfg):
    """A second GauGAN edit whose windows differ in shape from
    :func:`gaugan_edit_pair`'s at every level: a 3% square at
    (H/2, 5W/8)."""
    H, W = round(cfg.crop_size / cfg.aspect_ratio), cfg.crop_size
    return gaugan_edit_pair(cfg, frac=0.03, at=(H // 2, 5 * W // 8))


def limit_inside_forward(module):
    """Print and check cuDNN's benchmark limit as it is inside the engine's
    forwards of ``module`` (a forward hook reads it in the next forward):
    the engine's ``BENCHMARK_LIMIT``, which acts through cuDNN's v8 API
    (PyTorch's default on the card)."""
    from sige_torch.nn.engine import BENCHMARK_LIMIT

    def hook(mod, args):
        limit = torch.backends.cudnn.benchmark_limit
        handle.remove()
        print(f"  cudnn benchmark_limit inside a forward: {limit} (the "
              f"engine's BENCHMARK_LIMIT {BENCHMARK_LIMIT}; outside: "
              f"{precision_flags()[3]})", flush=True)
        if limit != BENCHMARK_LIMIT:
            raise AssertionError(f"benchmark_limit {limit} inside a forward, "
                                 f"the engine sets {BENCHMARK_LIMIT}")

    handle = module.register_forward_pre_hook(hook)


def phase_small_reference():
    """A tiny DDPM U-Net on the card against the same U-Net on the CPU (the
    CPU port is the one the tests hold against sige_tpu), in the tile
    layout and in the window layout with chains, and a tiny PD U-Net in
    the window layout; under PyTorch's default precision flags."""
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.models.pd import PDUNetConfig
    from sige_torch.runners import (DiffusionRunConfig, DiffusionRunner,
                                    PDRunConfig, PDRunner)

    ddpm = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                          attn_resolutions=(16,), resolution=32,
                          sparse_resolution_threshold=32)
    pd = PDUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(8,), resolution=32, temb_ch=64,
                      head_dim=16, sparse_resolution_threshold=16)
    original, edited = edit_pair(32)
    cases = [("DDPM", lambda dev, layout: DiffusionRunner(
                 ddpm, DiffusionRunConfig(sampler_type="ddim"),
                 layout=layout, device=dev, seed=0), layout)
             for layout in ("tiles", "window")]
    cases.append(("PD", lambda dev, layout: PDRunner(
        pd, PDRunConfig(), layout=layout, device=dev, seed=0), "window"))
    for name, make, layout in cases:
        outs = {}
        for dev in ("cpu", "cuda"):
            runner = make(dev, layout)
            if dev == "cuda" and name == "DDPM" and layout == "tiles":
                limit_inside_forward(runner.module)
            x0, x1, _ = runner.preprocess(original, edited)
            if runner.active_layout != layout:
                raise AssertionError(f"ran {runner.active_layout}, asked "
                                     f"for {layout}")
            cond = runner._cond()
            outs[dev] = [runner.model.full(x0, cond).cpu(),
                         runner.model.sparse(x1, cond).cpu()]
        err = max((a - b).abs().max().item()
                  for a, b in zip(outs["cpu"], outs["cuda"]))
        print(f"  tiny {name} U-Net card vs CPU, {layout} (full, sparse): max "
              f"err {err:.3e}", flush=True)
        if not (err <= TOL):
            raise AssertionError(f"tiny {name} U-Net card vs CPU ({layout}) "
                                 f"max err {err:.3e}")


STEPS = 5  # sampling steps of every full-width generate
RETIME_ITERS = 20  # forwards per mode and cuDNN setting in phase_retime


def events_ms(fn, iters):
    """Median and p90 of ``iters`` calls of ``fn``, each between two CUDA
    events."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return float(np.median(times)), float(np.percentile(times, 90))


def timed_calls(calls):
    """Host seconds of each ``(label, fn)`` in turn, each synchronised."""
    out = {}
    for label, fn in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[label] = time.perf_counter() - t0
    return out


def phase_retime(flash, rc):
    """What cuDNN's benchmark mode costs per new edit on the DDPM main
    path, and what it gains per forward. ``generate`` (layout auto ->
    window) on the first edit of the process's full-width DDPM shapes,
    again, on a second edit with other window shapes, again: each first
    call times cuDNN's algorithms for its new conv shapes (the first edit
    also pays the process's other first-use costs). Then the full and
    sparse forwards over the second edit's plan through the engine
    (benchmark mode) and through the same module with benchmark mode off
    (cuDNN's heuristic, still fp32), in turns: heuristic, engine, engine,
    heuristic."""
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.nn.module import SIGECtx
    from sige_torch.runners import DiffusionRunner

    cfg = DDPMUNetConfig()
    runner = DiffusionRunner(cfg, rc, device="cuda", seed=0)
    a, b = edit_pair(cfg.resolution), second_edit(cfg.resolution)
    secs = timed_calls([(label, lambda e=e: runner.generate(*e, seed=0))
                        for label, e in (("a_first", a), ("a_again", a),
                                         ("b_first", b), ("b_again", b))])
    print(f"  [retime] DDPM generate, s: first edit {secs['a_first']:.3f}, "
          f"again {secs['a_again']:.3f}; second edit (other windows) "
          f"{secs['b_first']:.3f}, again {secs['b_again']:.3f}", flush=True)

    x0, x1, _ = runner.preprocess(*b)
    t = torch.zeros((1,), device="cuda")

    def heuristic(mode, x):
        saved = precision_flags()
        set_precision_flags(("ieee", "ieee", False, saved[3]))
        try:
            with torch.inference_mode():
                runner.module(x, t, ctx=SIGECtx(mode=mode))
        finally:
            set_precision_flags(saved)

    fwd = {"full": (runner.model.full, x0), "sparse": (runner.model.sparse,
                                                        x1)}
    per = {}
    for mode, (engine, x) in fwd.items():
        for _ in range(3):
            heuristic(mode, x)
            engine(x, t)
        h1 = events_ms(lambda: heuristic(mode, x), RETIME_ITERS)
        e1 = events_ms(lambda: engine(x, t), RETIME_ITERS)
        e2 = events_ms(lambda: engine(x, t), RETIME_ITERS)
        h2 = events_ms(lambda: heuristic(mode, x), RETIME_ITERS)
        busy_h = device_ms(lambda: heuristic(mode, x), RETIME_ITERS)[0]
        busy_e = device_ms(lambda: engine(x, t), RETIME_ITERS)[0]
        per[mode] = {"heuristic_ms": [h1[0], h2[0]],
                     "benchmark_ms": [e1[0], e2[0]],
                     "heuristic_busy_ms": busy_h, "benchmark_busy_ms": busy_e}
        print(f"  [retime] DDPM {mode} forward median ms: heuristic "
              f"{h1[0]:.3f} / {h2[0]:.3f}, benchmark mode {e1[0]:.3f} / "
              f"{e2[0]:.3f}; kernel busy ms: heuristic {busy_h:.3f}, "
              f"benchmark mode {busy_e:.3f}", flush=True)
    # the gain in kernel busy time: the forwards are host-bound, so their
    # event times move with the host more than with the algorithms
    gain_ms = sum(n * (per[m]["heuristic_busy_ms"]
                       - per[m]["benchmark_busy_ms"])
                  for m, n in (("full", 1 + STEPS), ("sparse", STEPS)))
    extra = {e: 1e3 * (secs[f"{e}_first"] - secs[f"{e}_again"])
             for e in ("a", "b")}
    print(f"  [retime] per generate ({1 + STEPS} full + {STEPS} sparse "
          f"forwards) benchmark mode gains {gain_ms:.2f} ms of kernel busy "
          f"time; a new edit "
          f"costs {extra['b']:.1f} ms more than its repeat, the first "
          f"{extra['a']:.1f} ms", flush=True)
    del runner
    torch.cuda.empty_cache()
    return {"generate_s": secs, "forwards": per, "gain_ms_per_generate":
            float(gain_ms)}


def expected_launches(flash, cfg, forwards: int = 1 + 2 * STEPS):
    """Attention and combine launches of ``forwards`` full-width DDPM
    forwards: 5 attention calls at 16 px + 1 at 8 px per forward. The
    default counts one ``generate``: one forward in preprocess plus two
    per step (DDIM and DPM-Solver alike)."""
    calls = {256: 5, 64: 1}  # sequence length -> calls; one head
    D = cfg.ch * cfg.ch_mult[-1]  # 512 at both levels
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    combines = forwards * sum(
        n for seq, n in calls.items()
        if flash._num_splits(1, seq, seq, D, sms) > 1)
    return forwards * sum(calls.values()), combines


def planning_ms(name, model, plan, sparse_ms, n: int = 10):
    """Host ms of ``model.set_masks`` on the mask pyramids that ``plan()``
    hands to it (the host planner and the plan's one copy to the card,
    synchronised): median of ``n`` calls, printed beside the sparse
    forward's median ``sparse_ms``; the plan it sets is the one ``plan()``
    set."""
    seen = []

    def record(masks, *a, **kw):
        seen.append(masks)
        return type(model).set_masks(model, masks, *a, **kw)

    model.set_masks = record
    try:
        plan()
    finally:
        del model.set_masks
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.set_masks(seen[-1])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res = {"set_masks_ms": float(np.median(times)),
           "set_masks_ms_min_max": [min(times), max(times)],
           "sparse_ms": sparse_ms, "layout": model.state.active_layout}
    print(f"  [{name}] planning: set_masks {res['set_masks_ms']:.3f} ms "
          f"median of {n} (host clock, {min(times):.3f}-{max(times):.3f}; "
          f"{res['layout']}) beside the sparse forward's "
          f"{sparse_ms:.3f} ms median", flush=True)
    return res


def phase_path(flash, name, layout, want_layout, rc, profile_iters):
    """One full-width path through ``DiffusionRunner`` (``layout=None``:
    the runner's default); returns its launch counts of ``generate`` and,
    with ``profile_iters``, the dense and sparse ``profile`` results."""
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.runners import DiffusionRunner

    cfg = DDPMUNetConfig()
    t0 = time.perf_counter()
    kw = {} if layout is None else {"layout": layout}
    runner = DiffusionRunner(cfg, rc, device="cuda", seed=0, **kw)
    R = cfg.resolution
    original, edited = edit_pair(R)
    x0, x1, mask = runner.preprocess(original, edited)
    torch.cuda.synchronize()
    print(f"  [{name}] runner + preprocess: {time.perf_counter() - t0:.2f} s,"
          f" layout {runner.model.layout!r} ran {runner.active_layout!r}, "
          f"edit ratio {runner.last_edit_ratio:.4f}, params "
          f"{sum(p.numel() for p in runner.module.parameters()) / 1e6:.1f} M",
          flush=True)
    if runner.active_layout != want_layout:
        raise AssertionError(f"{name}: ran {runner.active_layout}, expected "
                             f"{want_layout}")

    if profile_iters:
        t = torch.zeros((1,), device="cuda")
        y_full = runner.model.full(x0, t)
        errs = [(runner.model.sparse(x0, t) - y_full).abs().max().item()]
        y_edit = runner.model.sparse(x1, t)
        errs.append((runner.model.sparse(x0, t) - y_full).abs().max().item())
        print(f"  [{name}] sparse(x0) vs full(x0): max err {errs[0]:.3e}; "
              f"after a sparse(x1): {errs[1]:.3e}", flush=True)
        if not all(e < TOL for e in errs):
            raise AssertionError(f"{name}: sparse(x0) != full(x0): {errs}")
        y_dense = runner.model.dense(x1, t)
        print(f"  [{name}] sparse(x1) vs dense(x1): max err "
              f"{(y_edit - y_dense).abs().max().item():.3e} (approximate by "
              f"design: folded norms keep the original's statistics)",
              flush=True)

    # the path, through the runner's own entry point: counters set to 0
    # just before, read just after
    flash.flash_mha.launches = 0
    flash.flash_mha.combine_launches = 0
    t0 = time.perf_counter()
    out = runner.generate(original, edited, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = flash.flash_mha.launches
    combines = flash.flash_mha.combine_launches
    want, want_combines = expected_launches(flash, cfg)
    print(f"  [{name}] generate: {STEPS} steps in {gen_s:.2f} s; flash "
          f"launches {launches} (expected {want}), combine launches "
          f"{combines} (one per attention call whose key range is split; "
          f"expected {want_combines})", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: flash launches {launches}, expected "
                             f"{want}")
    if combines != want_combines:
        raise AssertionError(f"{name}: combine launches {combines}, "
                             f"expected {want_combines}")
    if out.shape != (R, R, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{name}: generate output {out.shape}, finite "
                             f"{np.isfinite(out).all()}")

    prof = {}
    for mode in ("dense", "sparse") if profile_iters else ():
        prof[mode] = runner.profile(original, edited, mode=mode,
                                    iters=profile_iters)
        p = prof[mode]
        print(f"  [{name}] profile {mode}: {p['latency_ms']:.3f} ms median "
              f"(p90 {p['latency_p90_ms']:.3f}, n={p['iters']}), "
              f"{p['macs_g']:.2f} GMACs, peak {p['peak_mb']:.1f} MB",
              flush=True)
    planning = (planning_ms(name, runner.model,
                            lambda: runner.preprocess(original, edited),
                            prof["sparse"]["latency_ms"])
                if profile_iters else None)
    result = {"layout": runner.active_layout, "launches": launches,
              "combine_launches": combines, "generate_s": gen_s,
              "profile": prof, "planning": planning}
    del runner
    torch.cuda.empty_cache()
    return result


SD_STEPS, SD_STRENGTH, SD_GUIDANCE = 10, 0.5, 7.5  # 5 twin steps
SD_ITERS = 20  # timed forwards per model and mode


def sd_transformer_shapes(cfg, latent):
    """[(map side, channels)] of the SD U-Net's transformers in module
    order, from the config: in blocks, middle, out blocks."""
    mc, levels = cfg.model_channels, len(cfg.channel_mult)
    out, ds = [], 1
    for level, mult in enumerate(cfg.channel_mult):
        if ds in cfg.attention_resolutions:
            out += [(latent // ds, mult * mc)] * cfg.num_res_blocks
        if level != levels - 1:
            ds *= 2
    out.append((latent // ds, cfg.channel_mult[-1] * mc))
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        if ds in cfg.attention_resolutions:
            out += [(latent // ds, mult * mc)] * (cfg.num_res_blocks + 1)
        if level:
            ds //= 2
    return out


def _sparse_tokens(sparse_ok, gather, res):
    """(query tokens per batch row, whether the masked stale/fresh form
    runs) of one sparse-mode attention, from its gather's plan."""
    if not sparse_ok:
        return res * res, False
    if gather.planned_window():
        return gather.read_wsc((res, res))[1].numel(), True
    bh, bw = gather.geom.block_size
    return gather.plan["indices"].shape[0] * bh * bw, False


def sd_unet_calls(unet, latent, mode, update=False):
    """(B, N, M, heads, D) of every flash call of one forward of the U-Net
    ``unet`` (a ``SIGEModel``) at ``latent`` px with guidance (batch 2):
    per transformer block a self-attention (masked stale/fresh in the
    window chain, which ``sparse_update`` (``update``) turns off; over the
    full K/V map at a K/V-cached level, ``kv_cache_min_tokens``) and a
    cross-attention over 77 tokens."""
    from sige_torch.models.sd import SIGESpatialTransformer

    cfg = unet.module.cfg
    mods = [m for m in unet.module.modules()
            if isinstance(m, SIGESpatialTransformer)]
    shapes = sd_transformer_shapes(cfg, latent)
    if len(mods) != len(shapes):
        raise AssertionError(f"{len(mods)} transformers, config gives "
                             f"{len(shapes)}")
    calls = []
    for m, (res, ch) in zip(mods, shapes):
        H = cfg.num_heads
        N = M = res * res
        if mode == "sparse":
            N, masked = _sparse_tokens(m.sparse_ok, getattr(m, "gather", None),
                                       res)
            kv_cached = m.sparse_ok and res * res >= cfg.kv_cache_min_tokens
            if masked and cfg.window_chain and not kv_cached and not update:
                M = res * res + N
        calls += [(2, N, M, H, ch // H), (2, N, 77, H, ch // H)] * len(
            m.blocks)
    return calls


def sd_vae_calls(model, mode, update=False):
    """The flash call of one encoder or decoder forward (the mid block's
    single-head attention; its masked window-chain form off under
    ``sparse_update``, ``update``)."""
    m = model.module.mid_attn
    cfg = model.module.cfg
    res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
    N = M = res * res
    if mode == "sparse":
        N, masked = _sparse_tokens(m.sparse_ok, m.gather, res)
        M = res * res + (N if masked and cfg.window_chain and not update
                         else 0)
    return [(1, N, M, 1, m.channels)]


def expected_counts(flash, calls):
    """(attention launches, combine launches) of a list of flash calls."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return len(calls), sum(flash._num_splits(B * H, N, M, D, sms) > 1
                           for B, N, M, H, D in calls)


def forward_stats(flash, name, model, args, mode, calls, iters=SD_ITERS):
    """One model's forward in ``mode``: flash launches (asserted against
    ``calls``), latency (CUDA events around each of ``iters`` forwards,
    after 3 warm-ups: median and p90), analytic GMACs and peak MB."""
    from sige_torch.nn.module import SIGECtx

    fwd = {"dense": model.dense, "full": model.full,
           "sparse": model.sparse}[mode]
    flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
    fwd(*args)
    torch.cuda.synchronize()
    got = (flash.flash_mha.launches, flash.flash_mha.combine_launches)
    want = expected_counts(flash, calls)
    if got != want:
        raise AssertionError(f"{name} {mode}: flash launches {got}, "
                             f"expected {want}")
    for _ in range(3):
        fwd(*args)
    median, p90 = events_ms(lambda: fwd(*args), iters)
    ctx = SIGECtx(mode=mode, macs=[])
    with torch.inference_mode(), fp32_scope():
        model.module(*args, ctx=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd(*args)
    torch.cuda.synchronize()
    res = {"launches": got[0], "combine_launches": got[1],
           "latency_ms": median, "latency_p90_ms": p90,
           "iters": iters, "macs_g": sum(ctx.macs) / 1e9,
           "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
    print(f"  [{name}] {mode}: {res['latency_ms']:.3f} ms median (p90 "
          f"{res['latency_p90_ms']:.3f}, n={iters}), {res['macs_g']:.2f} "
          f"GMACs, peak {res['peak_mb']:.1f} MB, flash launches {got[0]} + "
          f"{got[1]} combine (expected {want[0]} + {want[1]})", flush=True)
    return res


def resident_mb(model):
    """Parameters and caches of one model, in MB (storages counted once)."""
    seen, total = set(), 0
    tensors = list(model.module.parameters()) + [
        t for m in model.module.modules() for t in getattr(
            m, "cache", {}).values()]
    for t in tensors:
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total / 2**20


def sd_model_calls(runner):
    """{(model, mode): flash calls of one forward} of an ``SDRunner``'s
    encoder, U-Net and decoder in full and sparse mode, over the plans
    its last ``sdedit`` set."""
    models = {"unet": runner.unet, "encoder": runner.encoder,
              "decoder": runner.decoder}
    return {(n, mode): (sd_unet_calls(m, runner.latent_hw[0], mode)
                        if n == "unet"
                        else sd_vae_calls(m, mode))
            for n, m in models.items() for mode in ("full", "sparse")}


def sdedit_calls(calls, t_enc):
    """The flash calls of one ``sdedit`` of ``t_enc`` twin steps."""
    return (calls["encoder", "full"] + calls["encoder", "sparse"]
            + calls["unet", "full"] * (1 + t_enc)
            + calls["unet", "sparse"] * t_enc
            + calls["decoder", "full"] + calls["decoder", "sparse"])


def sd_exact(runner, init, edit, uc, c):
    """sparse(x0) = full(x0) for the encoder, U-Net and decoder of an
    ``SDRunner``, also after a sparse pass on the edit, over the plans its
    last ``sdedit`` set, within 1e-4 * max(1, max|full|); returns (errors
    per model, {model: (full args, sparse args)})."""
    models = {"unet": runner.unet, "encoder": runner.encoder,
              "decoder": runner.decoder}
    uc, c = runner._tensor(uc), runner._tensor(c)
    x0, x1 = runner._image(init), runner._image(edit)
    z0 = runner.encode(x0)
    z1 = runner.encode(x1, mode="sparse")
    t = torch.full((2,), 501.0, device="cuda")
    ctx = torch.cat([uc, c])
    args = {"encoder": ((x0,), (x1,)),
            "unet": ((torch.cat([z0, z0]), t, ctx),
                     (torch.cat([z1, z1]), t, ctx)),
            "decoder": ((runner._pre_decode(z0),),
                        (runner._pre_decode(z1),))}
    exact = {}
    for n, (a0, a1) in args.items():
        model = models[n]
        full = model.full(*a0)
        errs = [(model.sparse(*a0) - full).abs().max().item()]
        model.sparse(*a1)
        errs.append((model.sparse(*a0) - full).abs().max().item())
        scale = max(1.0, full.abs().max().item())
        exact[n] = {"max_err": errs[0], "max_err_after_edit": errs[1],
                    "scale": scale, "tol": TOL * scale}
        print(f"  [sd {n}] sparse(x0) vs full(x0): max err {errs[0]:.3e}; "
              f"after a sparse(x1): {errs[1]:.3e}; tolerance 1e-4 * "
              f"max(1, max|full| = {scale:.3f}) = {TOL * scale:.3e}",
              flush=True)
        if not all(e <= TOL * scale for e in errs):
            raise AssertionError(f"sd {n}: sparse(x0) != full(x0): {errs}")
    return exact, args


def phase_sd(flash):
    """The SD SDEdit path at full width through ``SDRunner``: the SD v1
    U-Net (batch 2 with guidance 7.5), the VAE at 512^2, 10 DDIM steps at
    strength 0.5 (5 twin steps), random weights from seed 0, random text
    embeddings; the 512^2 form of the DDPM paths' edit."""
    from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
    from sige_torch.runners import SDRunConfig, SDRunner

    rc = SDRunConfig(ddim_steps=SD_STEPS, strength=SD_STRENGTH,
                     guidance_scale=SD_GUIDANCE)
    t0 = time.perf_counter()
    runner = SDRunner(SDUNetConfig(), SDVAEConfig(resolution=512), rc,
                      seed=0, device="cuda")
    torch.cuda.synchronize()
    models = {"unet": runner.unet, "encoder": runner.encoder,
              "decoder": runner.decoder}
    params = {n: sum(p.numel() for p in m.module.parameters()) / 1e6
              for n, m in models.items()}
    print(f"  [sd] runner: {time.perf_counter() - t0:.2f} s, params (M): "
          + ", ".join(f"{n} {v:.1f}" for n, v in params.items()),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    uc, c = (torch.randn(1, 77, 768, generator=gen, device="cuda")
             for _ in range(2))
    original, edited = edit_pair(runner.vae_cfg.resolution)
    init, edit = 2.0 * original - 1.0, 2.0 * edited - 1.0

    # the path, through the runner's own entry point: counters set to 0
    # just before, read just after
    flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
    t0 = time.perf_counter()
    out = runner.sdedit(init, edit, uc=uc, c=c, seed=0)
    torch.cuda.synchronize()
    sdedit_s = time.perf_counter() - t0
    launches = flash.flash_mha.launches
    combines = flash.flash_mha.combine_launches
    t_enc = int(rc.strength * rc.ddim_steps)
    calls = sd_model_calls(runner)
    want, want_combines = expected_counts(flash, sdedit_calls(calls, t_enc))
    print(f"  [sd] sdedit: {t_enc} twin steps in {sdedit_s:.2f} s; flash "
          f"launches {launches} (expected {want}), combine launches "
          f"{combines} (expected {want_combines})", flush=True)
    if (launches, combines) != (want, want_combines):
        raise AssertionError(f"sd: launches {launches} + {combines}, "
                             f"expected {want} + {want_combines}")
    R = runner.vae_cfg.resolution
    if out.shape != (R, R, 3) or not np.isfinite(out).all():
        raise AssertionError(f"sd: sdedit output {out.shape}, finite "
                             f"{np.isfinite(out).all()}")

    # sparse = full on the original, also after a sparse pass on the edit,
    # over the plans sdedit set
    exact, args = sd_exact(runner, init, edit, uc, c)

    # every distinct flash call of one full and one sparse forward per
    # model, with the biases the models built: the shapes of the SD kernel
    # rows (decoder first: (f) its mid attention, (g) the masked form), and
    # the launch counts' derivation checked against them
    recorded = record_flash_calls({n: (models[n], args[n])
                                   for n in ("decoder", "encoder", "unet")})
    derived = {(B, N, M, H, D) for n in models for mode in ("full", "sparse")
               for B, N, M, H, D in calls[n, mode]}
    if {k[:5] for k in recorded} != derived:
        raise AssertionError(f"sd: flash calls {sorted(recorded)}, derived "
                             f"{sorted(derived)}")
    print(f"  [sd] {len(recorded)} distinct flash calls (B, N, M, H, D, "
          f"masked): {sorted(recorded)}", flush=True)

    prof = {n: {mode: forward_stats(flash, f"sd {n}", models[n], args[n][0]
                                    if mode == "full" else args[n][1], mode,
                                    calls[n, mode])
                for mode in ("full", "sparse")}
            for n in ("unet", "decoder", "encoder")}
    masks, dec_masks = runner.edit_masks(init, edit)
    planning = {n: planning_ms(f"sd {n}", models[n],
                               lambda n=n, m=m: models[n].set_masks(m),
                               prof[n]["sparse"]["latency_ms"])
                for n, m in (("unet", masks), ("decoder", dec_masks))}
    dec = prof["decoder"]
    print(f"  [sd decoder] sparse forward {dec['sparse']['latency_ms']:.3f} "
          f"ms (peak {dec['sparse']['peak_mb']:.1f} MB) against full "
          f"{dec['full']['latency_ms']:.3f} ms (peak "
          f"{dec['full']['peak_mb']:.1f} MB)", flush=True)
    if not dec["sparse"]["latency_ms"] < dec["full"]["latency_ms"]:
        raise AssertionError("sd decoder: the sparse forward is not below "
                             "the full one")
    if not dec["sparse"]["peak_mb"] < 10e9 / 2**20:
        raise AssertionError(f"sd decoder: the sparse forward's peak "
                             f"{dec['sparse']['peak_mb']:.1f} MB is not under "
                             f"10 GB (cuDNN's FFT algorithm?)")
    resident = {n: resident_mb(m) for n, m in models.items()}
    print("  [sd] resident (params + caches) MB: " + ", ".join(
        f"{n} {v:.1f}" for n, v in resident.items()), flush=True)

    # what a new edit costs: the first sdedit above timed cuDNN's
    # algorithms for every shape; again, then a second edit (other
    # window shapes at every level), again
    b = [2.0 * a - 1.0 for a in second_edit(runner.vae_cfg.resolution)]
    secs = dict(a_first=sdedit_s, **timed_calls([
        (label, lambda e=e: runner.sdedit(*e, uc=uc, c=c, seed=0))
        for label, e in (("a_again", (init, edit)), ("b_first", b),
                         ("b_again", b))]))
    print(f"  [sd retime] sdedit, s: first edit {secs['a_first']:.3f}, "
          f"again {secs['a_again']:.3f}; second edit (other windows) "
          f"{secs['b_first']:.3f}, again {secs['b_again']:.3f}", flush=True)

    result = {"sdedit_s": sdedit_s, "launches": launches,
              "combine_launches": combines, "twin_steps": t_enc,
              "params_m": params, "exact": exact, "profile": prof,
              "resident_mb": resident, "retime_sdedit_s": secs,
              "planning": planning,
              "unet_calls": {m: len(calls["unet", m]) for m in
                             ("full", "sparse")}}
    del runner, models, args
    torch.cuda.empty_cache()
    return result, recorded


def record_calls(fn, seen, where):
    """Run ``fn`` with the attention entry recording each flash call whose
    (B, N, M, H, D, masked) key is not in ``seen`` (added to it):
    {key: (where, bias copy)}."""
    from sige_torch.ops import attention

    real, new = attention.flash_mha, {}

    def rec(qh, kh, vh, scale, bias=None):
        B, N, H, D = qh.shape
        key = (B, N, kh.shape[1], H, D, bias is not None)
        if key not in seen:
            seen.add(key)
            new[key] = (where, None if bias is None else bias.clone())
        return real(qh, kh, vh, scale, bias=bias)

    attention.flash_mha = rec
    try:
        out = fn()
    finally:
        attention.flash_mha = real
    torch.cuda.synchronize()
    return out, new


def record_flash_calls(models):
    """One full and one sparse forward of each model (``{name: (model,
    (full args, sparse args))}``) with the attention entry recording its
    flash calls: ``{(B, N, M, H, D, masked): (label, bias)}`` in the
    order of first call, each bias a copy of the one the model built."""
    seen, out = set(), {}
    for name, (model, (a0, a1)) in models.items():
        for mode, fwd, args in (("full", model.full, a0),
                                ("sparse", model.sparse, a1)):
            out.update(record_calls(lambda: fwd(*args), seen,
                                    f"{name} {mode}")[1])
    return out


def phase_sd_kernels(flash, recorded):
    """Kernel rows (f) on, one at every distinct flash call of the SD path:
    random q, k, v and the bias the model built."""
    rows = []
    for key, (where, bias) in recorded.items():
        B, N, M, H, D, masked = key
        kind = ("mid attention" if not where.startswith("unet") else
                "cross-attention over 77 text tokens" if M == 77 else
                "self-attention")
        label = (f"{chr(ord('f') + len(rows))}: SD {where} "
                 f"{'masked stale/fresh ' if masked else ''}{kind} "
                 f"(B {B}, N {N}, M {M}, H {H}, D {D})")
        rows.append(kernel_row(flash, label, B, N, M, H, D, bias))
    return rows


PD_ITERS = 20  # timed forwards per mode


def pd_attention_calls(cfg):
    """(B, N, M, heads, D) of every flash call of one PD U-Net forward at
    batch 1, from the config: the attention blocks at ``attn_resolutions``
    (``num_res_blocks`` per level down, one more up) and the middle
    block. They have no sparse path, so every mode makes the same calls."""
    levels = [(cfg.resolution >> i, cfg.ch * m)
              for i, m in enumerate(cfg.ch_mult)]
    maps = []
    for res, ch in levels:
        if res in cfg.attn_resolutions:
            maps += [(res, ch)] * cfg.num_res_blocks
    maps.append(levels[-1])
    for res, ch in reversed(levels):
        if res in cfg.attn_resolutions:
            maps += [(res, ch)] * (cfg.num_res_blocks + 1)
    return [(1, res * res, res * res, ch // cfg.head_dim, cfg.head_dim)
            for res, ch in maps]


def phase_pd(flash):
    """The PD SDEdit path at full width through ``PDRunner``: church pd256
    (``PDUNetConfig()``, random weights from seed 0), ``PDRunConfig()`` (8
    total steps, 5 sample steps from noise level 5), the DDPM paths'
    256^2 edit."""
    from sige_torch.models.pd import PDUNetConfig
    from sige_torch.runners import PDRunConfig, PDRunner

    cfg, rc = PDUNetConfig(), PDRunConfig()
    t0 = time.perf_counter()
    runner = PDRunner(cfg, rc, device="cuda", seed=0)
    original, edited = edit_pair(cfg.resolution)
    x0, x1, _ = runner.preprocess(original, edited)
    torch.cuda.synchronize()
    params_m = sum(p.numel() for p in runner.module.parameters()) / 1e6
    print(f"  [pd] runner + preprocess: {time.perf_counter() - t0:.2f} s, "
          f"layout {runner.model.layout!r} ran {runner.active_layout!r}, "
          f"edit ratio {runner.last_edit_ratio:.4f}, params {params_m:.1f} M",
          flush=True)
    if runner.active_layout != "window":
        raise AssertionError(f"pd: ran {runner.active_layout}, expected "
                             f"window")
    ls = runner._cond()
    full = runner.model.full(x0, ls)
    errs = [(runner.model.sparse(x0, ls) - full).abs().max().item()]
    runner.model.sparse(x1, ls)
    errs.append((runner.model.sparse(x0, ls) - full).abs().max().item())
    print(f"  [pd] sparse(x0) vs full(x0): max err {errs[0]:.3e}; after a "
          f"sparse(x1): {errs[1]:.3e}", flush=True)
    if not all(e < TOL for e in errs):
        raise AssertionError(f"pd: sparse(x0) != full(x0): {errs}")

    # the path, through the runner's own entry point: counters set to 0
    # just before, read just after
    flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
    t0 = time.perf_counter()
    out = runner.generate(original, edited, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = flash.flash_mha.launches
    combines = flash.flash_mha.combine_launches
    calls = pd_attention_calls(cfg)
    forwards = 1 + 2 * rc.sample_steps
    want, want_combines = expected_counts(flash, calls * forwards)
    print(f"  [pd] generate: {rc.sample_steps} twin steps in {gen_s:.2f} s; "
          f"flash launches {launches} (expected {want} = {len(calls)} per "
          f"forward x {forwards}), combine launches {combines} (expected "
          f"{want_combines})", flush=True)
    if (launches, combines) != (want, want_combines) or want != 242:
        raise AssertionError(f"pd: launches {launches} + {combines}, "
                             f"expected {want} (242) + {want_combines}")
    R = cfg.resolution
    if out.shape != (R, R, 3) or not np.isfinite(out).all():
        raise AssertionError(f"pd: generate output {out.shape}, finite "
                             f"{np.isfinite(out).all()}")

    recorded = record_flash_calls({"pd": (runner.model, ((x0, ls),
                                                         (x1, ls)))})
    if {k[:5] for k in recorded} != set(calls):
        raise AssertionError(f"pd: flash calls {sorted(recorded)}, derived "
                             f"{sorted(set(calls))}")
    print(f"  [pd] {len(recorded)} distinct flash calls (B, N, M, H, D, "
          f"masked): {sorted(recorded)}", flush=True)
    args = {"dense": (x1, ls), "full": (x0, ls), "sparse": (x1, ls)}
    prof = {mode: forward_stats(flash, "pd", runner.model, args[mode], mode,
                                calls, iters=PD_ITERS)
            for mode in ("dense", "full", "sparse")}
    planning = planning_ms("pd", runner.model,
                           lambda: runner.preprocess(original, edited),
                           prof["sparse"]["latency_ms"])
    resident = resident_mb(runner.model)
    print(f"  [pd] resident (params + caches) MB: {resident:.1f}",
          flush=True)
    result = {"layout": runner.active_layout, "params_m": params_m,
              "exact": errs, "generate_s": gen_s, "launches": launches,
              "combine_launches": combines, "profile": prof,
              "resident_mb": resident, "planning": planning}
    del runner
    torch.cuda.empty_cache()
    return result, recorded


def phase_pd_kernels(flash, recorded, first: str):
    """Kernel rows, one at every distinct flash call of the PD path
    (random q, k, v; no bias), labelled from ``first`` on."""
    rows = []
    for B, N, M, H, D, _ in recorded:
        label = (f"{chr(ord(first) + len(rows))}: PD self-attention "
                 f"{int(N ** 0.5)}^2 (B {B}, N {N}, M {M}, H {H}, D {D})")
        rows.append(kernel_row(flash, label, B, N, M, H, D, None))
    return rows


GAUGAN_ITERS = 20  # timed forwards per mode
GAUGAN_DENSE_GMACS = 281.3  # sige_tpu's count for SPADEGenConfig() (README)
SUB_MOBILE_CONFIG = "32_32_32_48_32_24_24_32"  # sige_tpu's default


def launches_per_forward(fn, iters: int = 5) -> float:
    """Kernels launched per call of ``fn``, from a torch.profiler trace of
    ``iters`` calls (after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _dev_time(e) > 0) / iters


def calibrate_bn_stats(runner, seg):
    """BatchNorm running statistics as training leaves them: each norm's
    per-channel mean and variance of its input on ``seg``, from one dense
    pass in which every norm is calibrated just before it runs. They are
    away from flax's 0 and 1, so the folds are exercised, and the
    activations keep the scale of a trained generator's (with statistics
    drawn at random they grow to ~100 through the blocks, PERF.md)."""
    def hook(mod, args):
        x = args[0]
        mod.running_mean.copy_(x.mean(dim=(0, 1, 2)))
        mod.running_var.copy_(x.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.register_forward_pre_hook(hook)
               for m in runner.module.modules() if hasattr(m, "running_var")]
    try:
        runner.model.dense(torch.as_tensor(seg, device=runner.device))
    finally:
        for h in handles:
            h.remove()


def _gaugan_exact(name, model, x0, x1):
    """sparse(x0) = full(x0), also after a sparse(x1), over the plan the
    runner set; returns (errors, full(x0))."""
    full = model.full(x0)
    errs = [(model.sparse(x0) - full).abs().max().item()]
    model.sparse(x1)
    errs.append((model.sparse(x0) - full).abs().max().item())
    print(f"  [{name}] sparse(x0) vs full(x0): max err {errs[0]:.3e}; after "
          f"a sparse(x1): {errs[1]:.3e}", flush=True)
    if not all(e < TOL for e in errs):
        raise AssertionError(f"{name}: sparse(x0) != full(x0): {errs}")
    return errs


def _gaugan_forwards(flash, name, runner, x0, x1, modes):
    """Per mode: flash launches (asserted 0), CUDA-event median and p90,
    GMACs, peak MB (``forward_stats``), and kernel launches per forward
    (profiler)."""
    args = {"dense": (x1,), "full": (x0,), "sparse": (x1,)}
    out = {}
    for mode in modes:
        out[mode] = forward_stats(flash, name, runner.model, args[mode],
                                  mode, [], iters=GAUGAN_ITERS)
        fwd = getattr(runner.model, mode)
        out[mode]["kernel_launches"] = launches_per_forward(
            lambda: fwd(*args[mode]))
        print(f"  [{name}] {mode}: {out[mode]['kernel_launches']:.1f} kernel "
              f"launches per forward", flush=True)
    return out


def phase_gaugan(flash):
    """The GauGAN semantic-editing path at full width through
    ``GauGANRunner``: the Cityscapes SPADE generator (``SPADEGenConfig()``:
    ngf 64, 36 semantic channels, 512x256, "more" upsampling, main blocks
    6, shortcut blocks 4, 5 sparse blocks, window chains and the sparse
    tail; 93.07 M parameters and BatchNorm statistics), random weights
    from seed 0 with the BatchNorm statistics calibrated on the original
    (:func:`calibrate_bn_stats`), ``sige_tpu/cli/gaugan.py``'s synthetic
    edit (~1.2% of
    the canvas set to class 34 at (H/3, W/3)); layout auto (window). Then
    the tile layout once, and the GAN-Compression sub-mobile generator
    (config 32_32_32_48_32_24_24_32, 20.19 M) on the same edit."""
    from sige_torch.models.gaugan import (SIGESubMobileSPADEGenerator,
                                          SPADEGenConfig, decode_config)
    from sige_torch.runners import GauGANRunner

    cfg = SPADEGenConfig()
    t0 = time.perf_counter()
    runner = GauGANRunner(cfg, device="cuda", seed=0)
    size_m = sum(t.numel() for t in runner.module.state_dict().values()) / 1e6
    labels, labels_b = gaugan_edit_pair(cfg), gaugan_second_edit(cfg)
    original, edited = (runner.preprocess_input(lab) for lab in labels)
    b = [runner.preprocess_input(lab) for lab in labels_b]
    calibrate_bn_stats(runner, original)
    torch.cuda.synchronize()
    print(f"  [gaugan] runner: {time.perf_counter() - t0:.2f} s, parameters "
          f"and BN statistics {size_m:.2f} M", flush=True)
    if round(size_m, 2) != 93.07:
        raise AssertionError(f"gaugan: {size_m:.3f} M, expected 93.07")

    # the path, through the runner's own entry point: counters set to 0
    # just before, read just after; GauGAN has no attention
    flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
    t0 = time.perf_counter()
    out = runner.generate(original, edited)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = flash.flash_mha.launches
    combines = flash.flash_mha.combine_launches
    print(f"  [gaugan] generate in {gen_s:.2f} s: layout "
          f"{runner.model.layout!r} ran {runner.active_layout!r}, edit ratio "
          f"{runner.last_edit_ratio:.4f}; flash launches {launches} + "
          f"{combines} combine (expected 0 + 0)", flush=True)
    if (launches, combines) != (0, 0):
        raise AssertionError(f"gaugan: flash launches {launches} + "
                             f"{combines}, expected 0")
    if runner.active_layout != "window":
        raise AssertionError(f"gaugan: ran {runner.active_layout}, expected "
                             f"window")
    H, W = original.shape[1:3]
    if out.shape != (H, W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"gaugan: generate output {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    # what a new edit costs: again, a second edit (other window shapes at
    # every level), again
    secs = dict(a_first=gen_s, **timed_calls([
        (label, lambda e=e: runner.generate(*e))
        for label, e in (("a_again", (original, edited)), ("b_first", b),
                         ("b_again", b))]))
    print(f"  [gaugan retime] generate, s: first edit {secs['a_first']:.3f}, "
          f"again {secs['a_again']:.3f}; second edit (other windows) "
          f"{secs['b_first']:.3f}, again {secs['b_again']:.3f}", flush=True)

    x0, x1, _ = runner.preprocess(original, edited)
    exact = _gaugan_exact("gaugan", runner.model, x0, x1)
    y_sparse, y_dense = runner.model.sparse(x1), runner.model.dense(x1)
    diff = (y_sparse - y_dense).abs()
    print(f"  [gaugan] sparse(x1) vs dense(x1): max {diff.max().item():.3e}, "
          f"mean {diff.mean().item():.3e} (approximate by design outside "
          f"the edit's receptive field)", flush=True)
    prof = _gaugan_forwards(flash, "gaugan", runner, x0, x1,
                            ("dense", "full", "sparse"))
    dense_g = prof["dense"]["macs_g"]
    if round(dense_g, 1) != GAUGAN_DENSE_GMACS:
        raise AssertionError(f"gaugan: dense {dense_g:.3f} GMACs, sige_tpu "
                             f"counts {GAUGAN_DENSE_GMACS}")
    planning = planning_ms("gaugan", runner.model,
                           lambda: runner.preprocess(original, edited),
                           prof["sparse"]["latency_ms"])
    resident = resident_mb(runner.model)
    print(f"  [gaugan] resident (params + caches) MB: {resident:.1f}",
          flush=True)
    state = runner.module.state_dict()
    del runner
    torch.cuda.empty_cache()

    # the tile layout once
    tiles = GauGANRunner(cfg, layout="tiles", device="cuda",
                         params=state)
    x0, x1, _ = tiles.preprocess(original, edited)
    if tiles.active_layout != "tiles":
        raise AssertionError(f"gaugan tiles: ran {tiles.active_layout}")
    tiles_exact = _gaugan_exact("gaugan tiles", tiles.model, x0, x1)
    tiles_prof = _gaugan_forwards(flash, "gaugan tiles", tiles, x0, x1,
                                  ("sparse",))
    del tiles, state
    torch.cuda.empty_cache()

    # the GAN-Compression sub-mobile generator on the same edit
    sub = GauGANRunner(cfg, module=SIGESubMobileSPADEGenerator(
        cfg, tuple(decode_config(SUB_MOBILE_CONFIG))), device="cuda", seed=0)
    calibrate_bn_stats(sub, original)
    sub_m = sum(t.numel() for t in sub.module.state_dict().values()) / 1e6
    x0, x1, _ = sub.preprocess(original, edited)
    print(f"  [gaugan sub-mobile] {SUB_MOBILE_CONFIG}: parameters and BN "
          f"statistics {sub_m:.2f} M, ran {sub.active_layout!r}", flush=True)
    if round(sub_m, 2) != 20.19:
        raise AssertionError(f"sub-mobile: {sub_m:.3f} M, expected 20.19")
    sub_exact = _gaugan_exact("gaugan sub-mobile", sub.model, x0, x1)
    sub_prof = _gaugan_forwards(flash, "gaugan sub-mobile", sub, x0, x1,
                                ("dense", "full", "sparse"))
    del sub
    torch.cuda.empty_cache()
    return {"layout": "window", "params_m": size_m, "generate_s": gen_s,
            "launches": launches, "combine_launches": combines,
            "retime_generate_s": secs, "exact": exact,
            "sparse_vs_dense": {"max": diff.max().item(),
                                "mean": diff.mean().item()},
            "profile": prof, "resident_mb": resident, "planning": planning,
            "tiles": {"exact": tiles_exact, "profile": tiles_prof},
            "sub_mobile": {"config": SUB_MOBILE_CONFIG, "params_m": sub_m,
                           "layout": "window", "exact": sub_exact,
                           "profile": sub_prof}}


DEMO_BUCKET_MIN = 8  # the demo server's at full width
DEMO_CPU_SLOT_MIB = 674.5  # cache MiB per slot of DDPMUNetConfig(), CPU count


def _storage_mb(tensors) -> float:
    """MB of the storages under ``tensors``, each counted once."""
    seen, total = set(), 0
    for t in tensors:
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total / 2**20


def quantized(image):
    """``image`` as the demo's PNGs carry it (the server's uint8
    conversion), so direct calls and HTTP requests see the same input."""
    from sige_torch.demo.server import to_uint8

    return to_uint8(image).astype(np.float32) / 255.0


def counted(flash, name, fn, want=None):
    """``fn()`` with the flash counters set to 0 just before and read just
    after, on the host clock (synchronised), with the device memory
    resident after it and its peak; ``want``: the (attention, combine)
    launches it must make."""
    flash.flash_mha.launches = 0
    flash.flash_mha.combine_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (flash.flash_mha.launches, flash.flash_mha.combine_launches)
    rec = {"s": secs, "launches": got[0], "combine_launches": got[1],
           "resident_mb": torch.cuda.memory_allocated() / 2**20,
           "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
    print(f"    {name}: {secs:.3f} s host, flash launches {got[0]} + "
          f"{got[1]} combine" + ("" if want is None else
                                 f" (expected {want[0]} + {want[1]})")
          + f", resident {rec['resident_mb']:.0f} MB, peak "
          f"{rec['peak_mb']:.0f} MB", flush=True)
    if want is not None and got != want:
        raise AssertionError(f"{name}: flash launches {got}, expected {want}")
    return out, rec


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _check(name, err, tol=TOL):
    print(f"    {name}: max err {err:.3e}", flush=True)
    if not err < tol:
        raise AssertionError(f"{name}: max err {err:.3e} (tolerance {tol})")


def demo_edit_mask(runner, base, edited):
    """The dilated difference mask ``generate`` plans for, on the card."""
    from sige_torch.core.masks import compute_difference_mask, dilate_mask
    from sige_torch.runners import data_transform

    mask = dilate_mask(compute_difference_mask(
        data_transform(base, True), data_transform(edited, True), eps=1e-2),
        runner.mask_dilate_radius)
    return torch.as_tensor(mask, device="cuda")


def sparse_replay(runner, image, mask):
    """The runner's sparse-only trajectory of ``image`` under its current
    plan, blended outside ``mask``, without an update."""
    from sige_torch.runners import data_transform

    with torch.inference_mode():
        x = torch.as_tensor(data_transform(image, True)[None], device="cuda")
        xt = runner.sampler.q_sample(x, runner.seq[-1], runner.base_e)
        if runner.sampler_type == "dpm_solver":
            out = runner._dpm_trajectory(xt, "sparse", mask)
        else:
            out = runner._sparse_trajectory(xt, mask, False)
    return runner._out(out)


def demo_single(flash, cfg, sampler, images):
    """One session through ``DemoRunner``: reset, generate, the sparse-only
    replay of the unedited base under the edit's plan, apply, the replay
    of the edit over the applied caches, the second edit; every request
    launches the flash kernels once per attention call of its forwards
    (one forward per step)."""
    from sige_torch.demo import DemoRunner

    base, edited, edited2 = images
    runner = DemoRunner(cfg, bucket_min=DEMO_BUCKET_MIN, sampler_type=sampler,
                        device="cuda")
    want = expected_launches(flash, cfg, len(runner.seq))
    print(f"  [{sampler}] {len(runner.seq)} steps (t {runner.seq[-1]} down "
          f"to {runner.seq[0]}), {runner.model.cache_slots} slots, layout "
          f"{runner.model.layout!r}", flush=True)
    outs, recs = {}, {}
    outs["reset"], recs["reset"] = counted(
        flash, "reset_base_image", lambda: runner.reset_base_image(base),
        want)
    state = runner.model.state
    slot_mb = [_storage_mb(state.tensors(k)) for k in range(3)]
    all_mb = _storage_mb(state.tensors())
    print(f"    caches: {all_mb:.1f} MB in {runner.model.cache_slots} slots, "
          f"slot 0/1/2 {slot_mb[0]:.1f}/{slot_mb[1]:.1f}/{slot_mb[2]:.1f} MB "
          f"(CPU count {DEMO_CPU_SLOT_MIB} MiB per slot), "
          f"{len(state.tensors(0))} tensors a slot", flush=True)
    for name, image, upd in (("generate", edited, False),
                             ("apply", edited, True)):
        outs[name], recs[name] = counted(
            flash, f"generate(sparse_update={upd})",
            lambda: runner.generate(image, sparse_update=upd), want)
        if name == "generate":
            cover = demo_edit_mask(runner, base, edited).float().mean()
            print(f"    layout ran {runner.model.active_layout!r}, dilated "
                  f"edit {cover.item():.4f} of the canvas", flush=True)
            # the unedited base under this edit's plan: every step reads
            # its own slot, so the reset's output comes back
            ones = torch.ones((cfg.resolution,) * 2, dtype=torch.bool,
                              device="cuda")
            _check("sparse-only replay of the base = reset",
                   _max_err(sparse_replay(runner, base, ones), outs["reset"]))
    _check("apply = generate", _max_err(outs["apply"], outs["generate"]))
    mask = demo_edit_mask(runner, base, edited)
    _check("sparse-only repeat over the applied caches = generate",
           _max_err(sparse_replay(runner, edited, mask), outs["generate"]))
    outs["second"], recs["second"] = counted(
        flash, "generate (3% second edit)", lambda: runner.generate(edited2),
        want)
    for k, o in outs.items():
        if o.shape != (cfg.resolution, cfg.resolution, 3) or not (
                np.isfinite(o).all()):
            raise AssertionError(f"{sampler} {k}: {o.shape}, finite "
                                 f"{np.isfinite(o).all()}")
    if _max_err(outs["generate"], outs["reset"]) < 1e-3:
        raise AssertionError(f"{sampler}: the edit changed nothing")
    result = {"requests": recs, "cache_mb": all_mb, "slot_mb": slot_mb[0],
              "slots": runner.model.cache_slots,
              "layout": runner.model.active_layout}
    del runner, state
    torch.cuda.empty_cache()
    return result, outs


def demo_http(flash, cfg, images, direct):
    """The HTTP server in-process over a fresh DDIM runner with the same
    weights: each response's image equals the direct run's output after
    the server's uint8 conversion."""
    import base64
    import threading
    import urllib.request
    from http.server import HTTPServer

    from sige_torch.demo import DemoRunner
    from sige_torch.demo.png import decode_png
    from sige_torch.demo.server import (array_to_data_url, make_handler,
                                        to_uint8)

    base, edited, edited2 = images
    R = cfg.resolution
    runner = DemoRunner(cfg, bucket_min=DEMO_BUCKET_MIN, device="cuda")
    httpd = HTTPServer(("127.0.0.1", 0), make_handler(runner, base, R))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url + path, data=data,
                                     method="GET" if body is None else "POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as res:
            raw = res.read()
        return raw, (time.perf_counter() - t0) * 1e3

    ms = {}
    try:
        page, _ = call("/")
        if f"const R = {R}" not in page.decode():
            raise AssertionError("the page does not draw at R x R")
        stamps, _ = call("/stamps")
        if len(json.loads(stamps)) != 4:
            raise AssertionError("stamps")
        flows = [("/reset", None, "base", "reset"),
                 ("/generate", edited, "image", "generate"),
                 ("/apply", edited, "image", "apply"),
                 ("/generate", edited2, "image", "second")]
        for path, image, key, ref in flows:
            body = {} if image is None else {"image": array_to_data_url(image)}
            raw, client_ms = call(path, body)
            js = json.loads(raw)
            got = decode_png(base64.b64decode(js[key].split(",", 1)[1]))
            want = to_uint8(direct[ref])
            diff = int(np.abs(got.astype(int) - want.astype(int)).max())
            ms[ref] = js["ms"]
            print(f"    POST {path} ({ref}): server {js['ms']:.1f} ms, client "
                  f"{client_ms:.1f} ms, response vs the direct run: max "
                  f"{diff} uint8 levels", flush=True)
            if diff:
                raise AssertionError(f"HTTP {ref}: {diff} levels off the "
                                     f"direct run")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    # the handler class holds the runner, and a class lives in reference
    # cycles: free its 17 GB of caches now, not at the next collection
    del runner, httpd, thread
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def session_images(R: int, S: int):
    """S distinct (base, edit) pairs: square edits of 1.2-3% at spread
    places, each base from its own seed."""
    places = [(R // 4, R // 4), (R // 2, 5 * R // 8), (5 * R // 8, R // 8),
              (R // 8, 5 * R // 8)]
    pairs = []
    for i in range(S):
        rng = np.random.default_rng(100 + i)
        base = rng.random((R, R, 3)).astype(np.float32)
        edited = base.copy()
        side = int(round(((0.012 + 0.006 * i) * R * R) ** 0.5))
        r, c = places[i]
        edited[r:r + side, c:c + side] = rng.random((side, side, 3))
        pairs.append((quantized(base), quantized(edited)))
    return pairs


def demo_sessions(flash, cfg, counts):
    """``MultiSessionDemoRunner`` at each S in ``counts``: every session's
    reset and generate equal an independent ``DemoRunner``'s with the same
    weights and noise; session 1's cache tensors are the same objects
    before and after session 0's apply."""
    from sige_torch.demo import DemoRunner, MultiSessionDemoRunner

    S_max = max(counts)
    pairs = session_images(cfg.resolution, S_max)
    single = DemoRunner(cfg, bucket_min=DEMO_BUCKET_MIN, device="cuda")
    refs = []
    for i, (base, edited) in enumerate(pairs):
        refs.append((single.reset_base_image(base, seed=i),
                     single.generate(edited)))
    del single
    torch.cuda.empty_cache()
    results = {}
    for S in counts:
        multi = MultiSessionDemoRunner(S, cfg, bucket_min=DEMO_BUCKET_MIN,
                                       device="cuda")
        errs, gen_s = [], []
        for i in range(S):
            errs.append(_max_err(multi.reset_base_image(i, pairs[i][0],
                                                        seed=i), refs[i][0]))
        resident = torch.cuda.memory_allocated() / 2**20
        per_session = [_storage_mb(s.state.tensors()) for s in multi.sessions]
        for i in range(S):
            out, rec = counted(flash, f"S={S} session {i} generate",
                               lambda: multi.generate(i, pairs[i][1]),
                               None)
            gen_s.append(rec["s"])
            errs.append(_max_err(out, refs[i][1]))
        _check(f"S={S}: every session's reset and generate = an independent "
               f"runner's", max(errs))
        ids1 = [id(t) for t in multi.sessions[1].state.tensors()]
        multi.generate(0, pairs[0][1], sparse_update=True)
        if [id(t) for t in multi.sessions[1].state.tensors()] != ids1:
            raise AssertionError(f"S={S}: session 0's apply touched session "
                                 f"1's caches")
        print(f"    S={S}: generate {np.median(gen_s) * 1e3:.1f} ms median "
              f"({min(gen_s) * 1e3:.1f}-{max(gen_s) * 1e3:.1f}), caches "
              f"{np.mean(per_session):.1f} MB per session, resident "
              f"{resident:.0f} MB; session 1's caches untouched by session "
              f"0's apply", flush=True)
        results[S] = {"generate_s": gen_s, "session_mb": per_session,
                      "resident_mb": resident, "max_err": max(errs)}
        del multi
        torch.cuda.empty_cache()
    return results


def demo_session_server(flash, cfg, S=4, iters=5):
    """``SessionServer`` in the window layout at S sessions: prime,
    per-session masks, a step on the originals (= the dense forward per
    session), steps on the edits, ``sparse_update``."""
    from sige_torch.core.masks import dilate_mask, downsample_mask
    from sige_torch.models.ddpm import SIGEFusedUNet
    from sige_torch.parallel import SessionServer

    R = cfg.resolution
    server = SessionServer(SIGEFusedUNet(cfg), bucket_min=DEMO_BUCKET_MIN,
                           device="cuda")
    server.model.init(0)
    pairs = session_images(R, S)
    x0 = torch.as_tensor(np.stack([2 * b[None] - 1 for b, _ in pairs]),
                         device="cuda")
    x1 = torch.as_tensor(np.stack([2 * e[None] - 1 for _, e in pairs]),
                         device="cuda")
    t = torch.full((S, 1), 100.0, device="cuda")
    server.prime(x0, t)
    for i, (b, e) in enumerate(pairs):
        m = dilate_mask(np.abs(e - b).max(-1) > 1e-2, 5)
        server.set_masks(i, downsample_mask(
            m, min_res=R // 2 ** (len(cfg.ch_mult) - 1)))
    layouts = {st.active_layout for st in server.states}
    y0 = server.step(x0, t)
    dense = torch.stack([server.model.dense(x0[i], t[i]) for i in range(S)])
    _check("SessionServer step on the originals = dense",
           (y0 - dense).abs().max().item())
    want = expected_launches(flash, cfg, S)  # one forward per session
    y1, rec = counted(flash, f"step, S={S}", lambda: server.step(x1, t), want)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.step(x1, t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    y_upd = server.step(x1, t, sparse_update=True)
    _check("step(sparse_update=True) = step", (y_upd - y1).abs().max().item())
    _check("step over the committed caches = step",
           (server.step(x1, t) - y1).abs().max().item())
    ms = float(np.median(times))
    print(f"    SessionServer ({sorted(layouts)}, S={S}): step {ms:.1f} ms median "
          f"of {iters} ({ms / S:.1f} ms per session)", flush=True)
    del server
    torch.cuda.empty_cache()
    return {"step_ms": times, "ms_per_session": ms / S,
            "layouts": sorted(layouts)}


def phase_demo(flash):
    """Phase 12: the interactive editing path at church256 full width.
    Four sessions hold 66 GB of caches: the earlier phases' models go
    first, cycles included."""
    from sige_torch.models.ddpm import DDPMUNetConfig

    gc.collect()
    torch.cuda.empty_cache()

    cfg = DDPMUNetConfig()
    R = cfg.resolution
    base, edited = (quantized(a) for a in edit_pair(R))
    edited2 = quantized(second_edit(R)[1])
    images = (base, edited, edited2)
    result, direct = {}, {}
    for sampler in ("ddim", "dpm_solver"):
        result[sampler], direct[sampler] = demo_single(flash, cfg, sampler,
                                                       images)
    print("  [http] the demo server in-process (DDIM):", flush=True)
    result["http_ms"] = demo_http(flash, cfg, images, direct["ddim"])
    print("  [sessions] MultiSessionDemoRunner:", flush=True)
    result["sessions"] = demo_sessions(flash, cfg, (2, 4))
    print("  [server] SessionServer:", flush=True)
    result["session_server"] = demo_session_server(flash, cfg)
    return result


# --- phase 13: reference checkpoints and the command lines -----------------

_DDPM_NAMES = [  # the port's module names -> the reference's (DDPM, PD, VAE)
    (r"^down_blocks\.(\d+)\.(\d+)\.", r"down.\1.block.\2."),
    (r"^down_attns\.(\d+)\.(\d+)\.", r"down.\1.attn.\2."),
    (r"^up_blocks\.(\d+)\.(\d+)\.", r"up.\1.block.\2."),
    (r"^up_attns\.(\d+)\.(\d+)\.", r"up.\1.attn.\2."),
    (r"^downsamples\.(\d+)\.", r"down.\1.downsample."),
    (r"^upsamples\.(\d+)\.", lambda m: f"up.{int(m.group(1)) + 1}.upsample."),
    (r"^mid_block1\.", "mid.block_1."), (r"^mid_block2\.", "mid.block_2."),
    (r"^mid_attn\.", "mid.attn_1."),
    (r"^temb_dense(\d)\.", r"temb.dense.\1."),
    (r"^temb_proj\.", "temb.dense.2."),   # the fused projection (top level)
    (r"^norm_out_scale$", "norm_out.weight"),
    (r"^norm_out_bias$", "norm_out.bias"),
]
_SD_UNET_NAMES = [
    (r"^in_blocks\.(\d+)\.",
     lambda m: f"input_blocks.{int(m.group(1)) + 1}."),
    (r"^out_blocks\.", "output_blocks."),
    (r"^mid_block1\.", "middle_block.0."), (r"^mid_attn\.", "middle_block.1."),
    (r"^mid_block2\.", "middle_block.2."),
    (r"^time_dense0\.", "time_embed.0."), (r"^time_dense1\.", "time_embed.2."),
    (r"^conv_in\.", "input_blocks.0.0."), (r"^conv_out\.", "out.2."),
    (r"^out_norm_scale$", "out.0.weight"), (r"^out_norm_bias$", "out.0.bias"),
    # inside a SpatialTransformer block
    (r"\.blocks\.(\d+)\.", r".transformer_blocks.\1."),
    (r"\.to_out\.", ".to_out.0."), (r"\.ff\.proj\.", ".ff.net.0.proj."),
    (r"\.ff\.out\.", ".ff.net.2."),
]
_SD_RESBLOCK_NAMES = [  # openaimodel ResBlock (not inside a transformer)
    (r"\.norm1\.", ".in_layers.0."), (r"\.conv1\.", ".in_layers.2."),
    (r"\.emb_proj\.", ".emb_layers.1."), (r"\.norm2\.", ".out_layers.0."),
    (r"\.conv2\.", ".out_layers.3."), (r"\.skip\.", ".skip_connection."),
]
_GAUGAN_NAMES = [
    (r"^(head|G_middle|up)\.(\d+)\.", r"\1_\2."),
    (r"\.norm\.(\d+)\.", r".norm_\1."), (r"\.conv\.(\d+)\.", r".conv_\1."),
    (r"\.mlp_shared\.", ".mlp_shared.0."),
    (r"\.running_(mean|var)$", r".param_free_norm.running_\1"),
    (r"\.dw\.", ".conv.0."), (r"\.pw\.", ".conv.2."),  # SeparableConv2d
]


def reference_key(family: str, key: str) -> str:
    """The reference checkpoint's name of the port's state-dict ``key``
    for a model of ``family`` ("ddpm": the DDPM fused and vanilla U-Nets,
    the PD U-Net and the SD VAE; "sd_unet"; "gaugan"), as
    ``tests/test_vanilla_ddpm.py _flax_path_to_torch_key``,
    ``tests/test_convert.py``, ``tests/test_convert_sd.py`` and
    ``tests/test_gaugan_vanilla.py`` name them from ``sige_tpu``'s trees."""
    import re

    rules = {"ddpm": _DDPM_NAMES, "sd_unet": _SD_UNET_NAMES,
             "gaugan": _GAUGAN_NAMES}[family]
    if family == "sd_unet" and ".blocks." not in key:
        rules = rules + _SD_RESBLOCK_NAMES
    for pattern, repl in rules:
        key = re.sub(pattern, repl, key)
    return key


def reference_layout(family: str, module, prefix: str = "", widths=None):
    """{reference key: shape} of a reference checkpoint of the port's
    ``module`` (built on the meta device: no memory): its state dict's
    keys renamed by :func:`reference_key`, under ``prefix``; ``widths``
    maps a port key to the length the reference stores instead (the
    sub-mobile checkpoints' running statistics at nominal width)."""
    return {prefix + reference_key(family, k):
            ((widths(k),) if widths and widths(k) else tuple(v.shape))
            for k, v in module.state_dict().items()}


def sub_mobile_widths(cfg):
    """The sub-mobile checkpoints' running statistics at the nominal
    (uncompressed, every channel ``ngf``) width of their block: ``norm_0``
    and ``norm_s`` at the block's input, ``norm_1`` at its output
    (``sige_torch/utils/convert.py sub_mobile_block_dims``)."""
    import re

    from sige_torch.utils.convert import sub_mobile_block_dims

    dims = sub_mobile_block_dims((cfg.ngf,) * 8, cfg.ngf)

    def width(key):
        m = re.match(r"^(head|G_middle|up)\.(\d+)\.norm(_s|\.0|\.1)\."
                     r"running_", key)
        if m is None:
            return None
        ic, channel, _, _ = dims[f"{m.group(1)}_{m.group(2)}"]
        return channel if m.group(3) == ".1" else ic
    return width


def sd_reference_layout(unet_cfg, vae_cfg):
    """{key: shape} of an sd-v1 LDM checkpoint of these configs: the
    U-Net under ``model.diffusion_model.``, the VAE under
    ``first_stage_model.`` with ``quant_conv`` and ``post_quant_conv``
    (``sige_tpu/utils/convert_sd.py:253-255``)."""
    from sige_torch.models.sd import SIGEDecoder, SIGEEncoder, SIGESDUNet

    with torch.device("meta"):
        unet, enc, dec = (SIGESDUNet(unet_cfg), SIGEEncoder(vae_cfg),
                          SIGEDecoder(vae_cfg))
    z = vae_cfg.z_channels
    layout = reference_layout("sd_unet", unet, "model.diffusion_model.")
    layout.update(reference_layout("ddpm", enc, "first_stage_model.encoder."))
    layout.update(reference_layout("ddpm", dec, "first_stage_model.decoder."))
    layout.update({"first_stage_model.quant_conv.weight": (2 * z, 2 * z, 1, 1),
                   "first_stage_model.quant_conv.bias": (2 * z,),
                   "first_stage_model.post_quant_conv.weight": (z, z, 1, 1),
                   "first_stage_model.post_quant_conv.bias": (z,)})
    return layout


def reference_values(layout, seed: int = 0, device="cuda"):
    """A reference state dict of ``layout`` on the CPU, drawn on
    ``device`` from ``seed`` in key order: conv and linear weights
    lecun-normal, norm weights 1 + 0.1 N(0, 1), biases and running means
    0.1 N(0, 1), running variances uniform in [0.5, 1.5]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for key in sorted(layout):
        shape = layout[key]
        x = torch.randn(shape, generator=gen, device=device)
        if key.endswith("running_var"):
            x = 0.5 + torch.rand(shape, generator=gen, device=device)
        elif len(shape) >= 2:
            x *= float(np.prod(shape[1:])) ** -0.5
        elif key.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x *= 0.1
        out[key] = x.cpu()
    return out


def _run_cli(main, argv):
    """``main(argv)`` with its standard output captured (and printed);
    returns (runner, output, host seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        runner = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"    | {line}", flush=True)
    return runner, out, secs


def _expect_lines(name, out, *patterns):
    import re

    for pat in patterns:
        if not re.search(pat, out, re.M):
            raise AssertionError(f"{name}: no line matching {pat!r} in the "
                                 f"CLI's output")


_PROFILE_LINE = (r"^Image synthetic: Sparsity [\d.]+%    MACs [\d.]+G    "
                 r"Avg Time [\d.]+ms$")
_GENERATE_LINE = (r"^Image synthetic: Edit Ratio [\d.]+%    Tiles \d+/\d+"
                  r"    Time [\d.]+s$")
_GAUGAN_LINE = r"^Image synthetic: Edit Ratio [\d.]+%    Tiles \d+/\d+$"


class _Seconds(dict):
    """Host seconds of each labelled step, printed on a line of its own."""

    def __call__(self, label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self[label] = time.perf_counter() - t0
        print(f"    {label}: {self[label]:.3f} s", flush=True)
        return out


def _save_and_load(secs, name, path, ref, load, convert, native_dir,
                   device="cuda"):
    """``torch.save`` of the reference dict, then, each timed: the port's
    reading of it, its conversion, the native save and load (onto the
    card) of what the conversion gave; returns the converted state."""
    from sige_torch.utils import checkpoint

    secs(f"{name} torch.save (reference .pth)", lambda: torch.save(ref, path))
    sd = secs(f"{name} torch.load (load_torch_state_dict)", lambda: load(path))
    conv = secs(f"{name} convert", lambda: convert(sd))
    del sd
    secs(f"{name} native save (save_params)",
         lambda: checkpoint.save_params(native_dir, conv))
    back = secs(f"{name} native load (load_params, onto the card)",
                lambda: checkpoint.load_params(native_dir, device))
    def flat(params):  # SD's {"unet", ...} mapping or one state dict
        if "unet" not in params:
            return params
        return {f"{m}.{k}": v for m in ("unet", "encoder", "decoder")
                for k, v in params[m].items()}

    flat_a, flat_b = flat(conv), flat(back)
    if flat_a.keys() != flat_b.keys() or not all(
            torch.equal(flat_a[k], flat_b[k].cpu()) for k in flat_a):
        raise AssertionError(f"{name}: the native round trip changed the "
                             f"weights")
    return conv


def _exact(name, model, a0, a1):
    """sparse(x0) = full(x0), also after a sparse(x1) (< 1e-4)."""
    full = model.full(*a0)
    errs = [(model.sparse(*a0) - full).abs().max().item()]
    model.sparse(*a1)
    errs.append((model.sparse(*a0) - full).abs().max().item())
    print(f"  [{name}] sparse(x0) vs full(x0): max err {errs[0]:.3e}; after "
          f"a sparse(x1): {errs[1]:.3e}", flush=True)
    if not all(e < TOL for e in errs):
        raise AssertionError(f"{name}: sparse(x0) != full(x0): {errs}")
    return errs


def checkpoint_ddpm(flash, tmp, secs):
    """DDPM church256 through a reference *vanilla* checkpoint: profile and
    generate through ``cli.diffusion`` with ``model.network=ddpm.unet``
    (the fuse surgery), the fused dense forward against the port's
    ``VanillaDDPMUNet`` on the unfused conversion, sparse = full, the
    flash launches, and the native round trip bit for bit."""
    import os

    from sige_torch.cli import diffusion
    from sige_torch.models.ddpm import DDPMUNetConfig, VanillaDDPMUNet
    from sige_torch.utils import convert

    cfg = DDPMUNetConfig()
    with torch.device("meta"):
        layout = reference_layout("ddpm", VanillaDDPMUNet(cfg))
    ref = secs("ddpm reference values", lambda: reference_values(layout, 0))
    pth = os.path.join(tmp, "church256-ddpm-unet.pth")
    _save_and_load(secs, "ddpm", pth, ref, convert.load_torch_state_dict,
                   convert.convert_ddpm_unet_to_fused,
                   os.path.join(tmp, "ddpm-native-direct"))
    base = ["--config_path", "configs/church_ddim256-sige.yml", "--hparams",
            f"model.network=ddpm.unet sampling.sample_steps={STEPS}",
            "--synthetic", "--device", "cuda"]
    warm, iters = 3, 10
    counts = {}
    flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
    runner, out, secs["ddpm cli profile"] = _run_cli(diffusion.main, base + [
        "--restore_from", pth, "--mode", "profile",
        "--warmup_times", str(warm), "--test_times", str(iters)])
    print(f"    ddpm cli profile: {secs['ddpm cli profile']:.3f} s", flush=True)
    counts["profile"] = (flash.flash_mha.launches,
                         flash.flash_mha.combine_launches)
    # preprocess (1 full), warm-ups, timed forwards, the peak-memory
    # forward, the MAC count
    want = expected_launches(flash, cfg, 3 + warm + iters)
    if counts["profile"] != want:
        raise AssertionError(f"ddpm cli profile: flash launches "
                             f"{counts['profile']}, expected {want}")
    _expect_lines("ddpm cli profile", out, _PROFILE_LINE)

    original, edited = diffusion.synthetic_pair(cfg.resolution, 0)
    x0, x1, _ = runner.preprocess(original, edited)
    t = torch.full((1,), 500.0, device="cuda")
    exact = _exact("ddpm ckpt", runner.model, (x0, t), (x1, t))
    _, per_forward = counted(flash, "ddpm dense forward",
                             lambda: runner.model.dense(x1, t),
                             expected_launches(flash, cfg, 1))
    vanilla = convert.load_converted(
        VanillaDDPMUNet(cfg), convert.convert_ddpm_vanilla_unet(ref)).cuda()
    fused_vs_vanilla = (runner.model.dense(x1, t) - vanilla(x1, t)).abs()
    fused_vs_vanilla = fused_vs_vanilla.max().item()
    _check("fused dense (convert_ddpm_unet_to_fused) = VanillaDDPMUNet "
           "(convert_ddpm_vanilla_unet), t 500", fused_vs_vanilla)
    del vanilla, runner

    native = os.path.join(tmp, "ddpm-native")
    runs = {}
    for label, extra in (("pth", ["--restore_from", pth, "--save_converted",
                                  native]),
                         ("native", ["--restore_from", native])):
        flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
        save_dir = os.path.join(tmp, f"ddpm-out-{label}")
        runner, out, s = _run_cli(diffusion.main, base + extra + [
            "--mode", "generate", "--save_dir", save_dir])
        secs[f"ddpm cli generate ({label})"] = s
        print(f"    ddpm cli generate ({label}): {s:.3f} s", flush=True)
        counts[f"generate_{label}"] = (flash.flash_mha.launches,
                                       flash.flash_mha.combine_launches)
        if counts[f"generate_{label}"] != expected_launches(flash, cfg):
            raise AssertionError(f"ddpm cli generate ({label}): flash "
                                 f"launches {counts[f'generate_{label}']}, "
                                 f"expected {expected_launches(flash, cfg)}")
        _expect_lines(f"ddpm cli generate ({label})", out, _GENERATE_LINE,
                      r"^saved .*synthetic\.png$")
        with open(os.path.join(save_dir, "synthetic.png"), "rb") as f:
            png = f.read()
        if not os.path.exists(os.path.join(save_dir, "index.html")):
            raise AssertionError("ddpm cli generate: no gallery")
        runs[label] = (runner.module.state_dict(),
                       runner.generate(original, edited, seed=0), png)
        del runner
    same_weights = all(torch.equal(runs["pth"][0][k], runs["native"][0][k])
                       for k in runs["pth"][0])
    same_out = np.array_equal(runs["pth"][1], runs["native"][1])
    same_png = runs["pth"][2] == runs["native"][2]
    print(f"    native round trip (--save_converted, then --restore_from): "
          f"weights equal {same_weights}, generate output equal "
          f"{same_out}, PNG bytes equal {same_png}", flush=True)
    if not (same_weights and same_out and same_png):
        raise AssertionError("ddpm: --restore_from of the --save_converted "
                             "directory differs from the .pth run")
    torch.cuda.empty_cache()
    return {"flash_counts": counts, "per_forward": per_forward,
            "exact": exact, "fused_vs_vanilla": fused_vs_vanilla}


def checkpoint_pd(flash, tmp, secs):
    """PD church pd256 through a reference PD checkpoint and
    ``cli.diffusion`` with ``configs/church_pd256-sige.yml``."""
    import os

    from sige_torch.cli import diffusion
    from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
    from sige_torch.utils import convert

    cfg = PDUNetConfig()
    with torch.device("meta"):
        layout = reference_layout("ddpm", SIGEPDUNet(cfg))
    ref = secs("pd reference values", lambda: reference_values(layout, 1))
    pth = os.path.join(tmp, "church256-pd-unet.pth")
    _save_and_load(secs, "pd", pth, ref, convert.load_torch_state_dict,
                   convert.convert_pd_unet, os.path.join(tmp, "pd-native"))
    flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
    runner, out, s = _run_cli(diffusion.main, [
        "--config_path", "configs/church_pd256-sige.yml", "--synthetic",
        "--restore_from", pth, "--mode", "generate", "--device", "cuda"])
    secs["pd cli generate"] = s
    print(f"    pd cli generate: {s:.3f} s", flush=True)
    got = (flash.flash_mha.launches, flash.flash_mha.combine_launches)
    calls = pd_attention_calls(cfg)
    want = expected_counts(flash, calls * (1 + 2 * runner.run_cfg.sample_steps))
    print(f"    pd cli generate: flash launches {got[0]} + {got[1]} combine "
          f"(expected {want[0]} + {want[1]})", flush=True)
    if got != want or want[0] != 242:
        raise AssertionError(f"pd cli: flash launches {got}, expected {want}")
    _expect_lines("pd cli generate", out, _GENERATE_LINE)
    original, edited = diffusion.synthetic_pair(cfg.resolution, 0)
    x0, x1, _ = runner.preprocess(original, edited)
    ls = runner._cond()
    exact = _exact("pd ckpt", runner.model, (x0, ls), (x1, ls))
    _, per_forward = counted(flash, "pd dense forward",
                             lambda: runner.model.dense(x1, ls),
                             expected_counts(flash, calls))
    if per_forward["launches"] != 22:
        raise AssertionError("pd: not 22 flash launches per forward")
    del runner
    torch.cuda.empty_cache()
    return {"flash_counts": got, "per_forward": per_forward, "exact": exact}


def checkpoint_sd(flash, tmp, secs):
    """SD v1 at 512^2 through an sd-v1 LDM checkpoint (U-Net, VAE,
    quant_conv and post_quant_conv) and ``cli.sd --task sdedit
    --synthetic --embeddings``, 5 twin steps. The checkpoint stays in
    ``tmp`` (phase 14 reads it)."""
    import os
    import shutil

    from sige_torch.cli import sd as sd_cli
    from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
    from sige_torch.utils import convert, convert_sd

    unet_cfg, vae_cfg = SDUNetConfig(), SDVAEConfig(resolution=512)
    layout = sd_reference_layout(unet_cfg, vae_cfg)
    ref = secs("sd reference values", lambda: reference_values(layout, 2))
    print(f"    sd reference state dict: {len(ref)} tensors, "
          f"{sum(v.numel() for v in ref.values()) * 4 / 1e9:.2f} GB",
          flush=True)
    pth = os.path.join(tmp, "sd-v1.ckpt")
    native = os.path.join(tmp, "sd-native")
    _save_and_load(secs, "sd", pth, ref, convert.load_torch_state_dict,
                   lambda sd: convert_sd.convert_sd(sd, resolution=512),
                   native)
    del ref
    shutil.rmtree(native)
    gen = torch.Generator().manual_seed(3)
    emb = os.path.join(tmp, "embeddings.npz")
    uc, c = (torch.randn(1, 77, 768, generator=gen).numpy() for _ in range(2))
    np.savez(emb, uc=uc, c=c)
    flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
    runner, out, s = _run_cli(sd_cli.main, [
        "--task", "sdedit", "--synthetic", "--embeddings", emb,
        "--restore_from", pth, "--ddim_steps", str(SD_STEPS), "--strength",
        str(SD_STRENGTH), "--scale", str(SD_GUIDANCE), "--save_dir",
        os.path.join(tmp, "sd-out"), "--device", "cuda"])
    secs["sd cli sdedit"] = s
    print(f"    sd cli sdedit: {s:.3f} s", flush=True)
    got = (flash.flash_mha.launches, flash.flash_mha.combine_launches)
    t_enc = int(SD_STRENGTH * SD_STEPS)
    calls = sd_model_calls(runner)
    want = expected_counts(flash, sdedit_calls(calls, t_enc))
    print(f"    sd cli sdedit: {t_enc} twin steps, flash launches {got[0]} + "
          f"{got[1]} combine (expected {want[0]} + {want[1]})", flush=True)
    if got != want:
        raise AssertionError(f"sd cli: flash launches {got}, expected {want}")
    _expect_lines("sd cli sdedit", out, r"^saved .*sdedit\.png$")
    # per full forward: 32 attention launches in the U-Net, 1 in each VAE
    # model; a combine launch for each call whose key range is split
    per_forward = {n: expected_counts(flash, calls[n, "full"])
                   for n in ("unet", "encoder", "decoder")}
    if {n: v[0] for n, v in per_forward.items()} != {
            "unet": 32, "encoder": 1, "decoder": 1}:
        raise AssertionError(f"sd: flash launches per full forward "
                             f"{per_forward}, expected U-Net 32 and VAE 1")
    init, edited, _ = sd_cli.synthetic_inputs(512, 512, 0)
    exact, args = sd_exact(runner, init, edited, uc, c)
    for n, model in (("unet", runner.unet), ("encoder", runner.encoder),
                     ("decoder", runner.decoder)):
        counted(flash, f"sd {n} full forward",
                lambda: model.full(*args[n][0]), per_forward[n])
    del runner, args
    torch.cuda.empty_cache()
    return {"flash_counts": got, "per_forward": per_forward,
            "exact": exact}


def checkpoint_gaugan(flash, tmp, secs):
    """The Cityscapes SPADE generator through three reference layouts and
    ``cli.gaugan --synthetic``: a fused checkpoint under
    ``sige_fused_spade``, a plain SPADE checkpoint under
    ``sige_fused_spade`` (the fusing surgery, chosen by the checkpoint's
    keys), and a fused sub-mobile checkpoint (running statistics at
    nominal width) under ``sige_fused_sub_mobile_spade``. Each reference
    dict holds BatchNorm statistics calibrated on the synthetic original
    through the port's conversion of it (:func:`calibrate_bn_stats`)."""
    import os

    from sige_torch.cli import gaugan
    from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                          SIGESubMobileSPADEGenerator,
                                          SPADEGenConfig,
                                          VanillaSPADEGenerator,
                                          decode_config)
    from sige_torch.runners import GauGANRunner
    from sige_torch.utils import convert

    cfg = SPADEGenConfig()
    channels = tuple(decode_config(SUB_MOBILE_CONFIG))
    nul = cfg.num_upsampling_layers
    cases = [
        ("fused", "sige_fused_spade", lambda: SIGEFusedSPADEGenerator(cfg),
         None, lambda sd: convert.convert_gaugan_fused_spade(sd, nul), None),
        ("spade", "sige_fused_spade", lambda: VanillaSPADEGenerator(cfg),
         None, lambda sd: convert.convert_gaugan_spade(sd, nul, fuse=True),
         None),
        ("sub_mobile", "sige_fused_sub_mobile_spade",
         lambda: SIGESubMobileSPADEGenerator(cfg, channels),
         sub_mobile_widths(cfg),
         lambda sd: convert.convert_gaugan_sub_mobile_spade(
             sd, channels=channels, ngf=cfg.ngf),
         lambda: SIGESubMobileSPADEGenerator(cfg, channels)),
    ]
    args = gaugan.get_args(["--synthetic"])
    item = gaugan.synthetic_items(args)[0]
    result = {}
    for i, (name, netg, make, widths, conv, engine_module) in enumerate(cases):
        with torch.device("meta"):
            layout = reference_layout("gaugan", make(), widths=widths)
        ref = secs(f"gaugan {name} reference values",
                   lambda: reference_values(layout, 4 + i))
        # BatchNorm statistics as training leaves them, through the port's
        # own reading of this checkpoint
        cal = GauGANRunner(cfg, params=conv(ref), device="cuda",
                           module=engine_module and engine_module())
        seg = cal.preprocess_input(item["original_label"],
                                   item["original_instance"])
        calibrate_bn_stats(cal, seg)
        for k, v in cal.module.state_dict().items():
            if "running_" in k:
                ref[reference_key("gaugan", k)][:v.numel()] = v.cpu()
        del cal
        pth = os.path.join(tmp, f"gaugan-{name}.pth")
        _save_and_load(secs, f"gaugan {name}", pth, ref,
                       convert.load_torch_state_dict, conv,
                       os.path.join(tmp, f"gaugan-{name}-native"))
        argv = ["--netG", netg, "--synthetic", "--restore_from", pth,
                "--mode", "generate", "--device", "cuda"]
        if "sub_mobile" in netg:
            argv += ["--config_str", SUB_MOBILE_CONFIG]
        flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
        runner, out, s = _run_cli(gaugan.main, argv)
        secs[f"gaugan {name} cli generate"] = s
        print(f"    gaugan {name} cli generate ({netg}): {s:.3f} s",
              flush=True)
        got = (flash.flash_mha.launches, flash.flash_mha.combine_launches)
        if got != (0, 0):
            raise AssertionError(f"gaugan {name}: flash launches {got}")
        _expect_lines(f"gaugan {name}", out, _GAUGAN_LINE)
        s0, s1 = (runner.preprocess_input(item[f"{k}_label"],
                                          item[f"{k}_instance"])
                  for k in ("original", "edited"))
        x0, x1, _ = runner.preprocess(s0, s1)
        result[name] = {"flash_counts": got, "netG": netg,
                        "exact": _exact(f"gaugan {name} ckpt", runner.model,
                                        (x0,), (x1,))}
        del runner, ref
        torch.cuda.empty_cache()
    return result


def phase_checkpoints(flash, tmp=None):
    """Phase 13: reference-layout checkpoints (keys and shapes from
    :func:`reference_layout`, values from seeds) written as .pth files
    into ``tmp`` (a temporary directory of its own when None), converted
    by the port and driven through its command lines at full width."""
    import tempfile

    if tmp is None:
        with tempfile.TemporaryDirectory(prefix="sige-ckpt-") as tmp:
            return phase_checkpoints(flash, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    secs = _Seconds()
    print("  [ddpm] church256 through a vanilla checkpoint:", flush=True)
    ddpm = checkpoint_ddpm(flash, tmp, secs)
    print("  [pd] church pd256:", flush=True)
    pd = checkpoint_pd(flash, tmp, secs)
    print("  [gaugan] Cityscapes SPADE at 512x256:", flush=True)
    gaugan = checkpoint_gaugan(flash, tmp, secs)
    print("  [sd] SD v1 at 512^2:", flush=True)
    sd = checkpoint_sd(flash, tmp, secs)
    return {"ddpm": ddpm, "pd": pd, "gaugan": gaugan, "sd": sd,
            "seconds": dict(secs)}



# --- phase 14: SD from a text prompt, the safety checker, the options -------

def synthetic_bpe(n_merges: int, seed: int = 0):
    """A seeded byte-level BPE vocabulary in CLIP's layout: the 256 byte
    symbols, their ``</w>`` forms, ``n_merges`` merges (each a new token;
    eight in ten join pieces of lower-case ASCII letters, so ordinary
    words merge over several ranks) and the two specials last. Returns
    ({token: id}, [(left, right), ...] in rank order)."""
    import string

    from sige_torch.models.sd.tokenizer import BOS, EOS, bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars]
    seen = set(tokens)
    letters = set(string.ascii_lowercase)
    ascii_lefts = [c for c in chars if c in letters]
    ascii_rights = ascii_lefts + [c + "</w>" for c in ascii_lefts]
    lefts, rights = list(chars), list(tokens)
    rng = np.random.default_rng(seed)
    merges = []
    while len(merges) < n_merges:
        ascii_pick = rng.random() < 0.8
        ls, rs = (ascii_lefts, ascii_rights) if ascii_pick else (lefts,
                                                                 rights)
        a, b = ls[rng.integers(len(ls))], rs[rng.integers(len(rs))]
        tok = a + b
        if tok in seen:
            continue
        seen.add(tok)
        merges.append((a, b))
        tokens.append(tok)
        rights.append(tok)
        if ascii_pick:
            ascii_rights.append(tok)
        if not tok.endswith("</w>"):
            lefts.append(tok)
            if ascii_pick:
                ascii_lefts.append(tok)
    tokens += [BOS, EOS]
    return {t: i for i, t in enumerate(tokens)}, merges


def _write_json(path, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def clip_text_state(cfg, seed: int = 0, device="cuda"):
    """Seeded weights of a CLIP text tower of ``cfg`` (the port's
    ``CLIPTextModel`` keys, values as :func:`reference_values` draws
    them), plus what torch snapshots carry beside them: an old
    ``position_ids`` buffer and the ``text_projection``."""
    from sige_torch.models.sd.clip import CLIPTextModel

    with torch.device("meta"):
        model = CLIPTextModel(cfg)
    layout = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    layout["text_projection.weight"] = (cfg.hidden_size, cfg.hidden_size)
    sd = reference_values(layout, seed, device)
    sd["text_model.embeddings.position_ids"] = torch.arange(
        cfg.max_position_embeddings)[None]
    return sd


def write_clip_snapshot(path, cfg, state_dict, seed: int = 0):
    """An ``openai/clip-vit-large-patch14``-layout snapshot of a CLIP text
    tower: ``vocab.json`` and ``merges.txt`` (:func:`synthetic_bpe`, as
    many merges as ``cfg.vocab_size`` leaves room for),
    ``special_tokens_map.json``, ``config.json`` (a ``CLIPConfig`` with
    its ``text_config``) and ``pytorch_model.bin``."""
    import dataclasses
    import os

    from sige_torch.models.sd.tokenizer import BOS, EOS

    os.makedirs(path, exist_ok=True)
    vocab, merges = synthetic_bpe(cfg.vocab_size - 514, seed)
    _write_json(os.path.join(path, "vocab.json"), vocab)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                             for a, b in merges))
    special = {name: {"content": tok, "lstrip": False, "normalized": True,
                      "rstrip": False, "single_word": False}
               for name, tok in (("bos_token", BOS), ("eos_token", EOS),
                                 ("unk_token", EOS))}
    special["pad_token"] = EOS
    _write_json(os.path.join(path, "special_tokens_map.json"), special)
    _write_json(os.path.join(path, "config.json"), {
        "model_type": "clip", "projection_dim": cfg.hidden_size,
        "text_config": dict(dataclasses.asdict(cfg), model_type=
                            "clip_text_model")})
    torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))


def safety_state(vcfg, projection_dim: int, seed: int = 0, device="cuda"):
    """Seeded weights of a ``StableDiffusionSafetyChecker`` in its torch
    layout: the CLIP vision trunk nested as
    ``vision_model.vision_model.*``, ``visual_projection`` (no bias), 17
    concept and 3 special-care embeddings and their thresholds (all 1:
    nothing trips until a caller sets them)."""
    from sige_torch.models.sd.safety import CLIPVisionModel

    with torch.device("meta"):
        model = CLIPVisionModel(vcfg)
    P = projection_dim
    layout = {"vision_model." + k: tuple(v.shape)
              for k, v in model.state_dict().items()}
    layout.update({"visual_projection.weight": (P, vcfg.hidden_size),
                   "concept_embeds": (17, P), "special_care_embeds": (3, P)})
    sd = reference_values(layout, seed, device)
    sd["concept_embeds_weights"] = torch.ones(17)
    sd["special_care_embeds_weights"] = torch.ones(3)
    return sd


def write_safety_snapshot(path, vcfg, projection_dim: int, state_dict):
    """A ``CompVis/stable-diffusion-safety-checker``-layout snapshot:
    ``config.json`` (a ``CLIPConfig`` with its ``vision_config``) and
    ``pytorch_model.bin``."""
    import dataclasses
    import os

    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, "config.json"), {
        "model_type": "clip", "projection_dim": projection_dim,
        "vision_config": dict(dataclasses.asdict(vcfg), model_type=
                              "clip_vision_model")})
    torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))



def split_thresholds(state, embeds):
    """Seeded thresholds that the first image of ``embeds`` (projected
    CLIP image embeddings, [2, P]) trips and the second does not: concept
    0 along embeds[0] - embeds[1] (the first image's cosine with it is
    the larger one), its threshold halfway between the two cosines; the
    other concepts and the special-care ones at 1 (never)."""
    e = torch.as_tensor(embeds[:2], dtype=torch.float64).cpu()
    d = e[0] - e[1]
    cos = torch.nn.functional.cosine_similarity(e, d[None], dim=1)
    if not cos[0] - cos[1] > 0.01:
        raise AssertionError(f"the two images' cosines {cos.tolist()} are "
                             f"too close to split")
    state["concept_embeds"][0] = d.float()
    state["concept_embeds_weights"][:] = 1.0
    state["concept_embeds_weights"][0] = float(cos.mean())
    state["special_care_embeds_weights"][:] = 1.0
    return cos.tolist()


def row_label(i: int) -> str:
    """The label of kernel row ``i``: a-z, then aa, ab, ..."""
    return chr(ord("a") + i) if i < 26 else "a" + chr(ord("a") + i - 26)


def trace_stats(fn, iters: int = 10):
    """(busy ms, kernel launches) per call of ``fn`` in a torch.profiler
    trace of ``iters`` calls (the device's activity only); (None, None)
    when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _dev_time(e) > 0]
    if not kernels:
        return None, None
    return (sum(_dev_time(e) for e in kernels) / 1e3 / iters,
            sum(e.count for e in kernels) / iters)


def forward_row(flash, name, model, args, mode, calls):
    """:func:`forward_stats` plus the trace's busy time (the sum of its
    kernels' times), kernel launches and idle share (1 - busy / median,
    floored at 0) of one forward."""
    res = forward_stats(flash, name, model, args, mode, calls)
    fwd = model.sparse if mode == "sparse" else model.full
    busy, kernels = trace_stats(lambda: fwd(*args))
    if busy is None:
        res.update(busy_ms=None, kernel_launches=None, idle_share=None)
        print(f"  [{name}] {mode}: the trace held no device activity: busy "
              f"time, launches and idle share not measured", flush=True)
        return res
    res.update(busy_ms=busy, kernel_launches=kernels,
               idle_share=max(0.0, 1.0 - busy / res["latency_ms"]))
    print(f"  [{name}] {mode}: busy {busy:.3f} ms, {kernels:.0f} kernel "
          f"launches, idle share {res['idle_share']:.3f}", flush=True)
    return res


def _close_to(name, got, ref):
    """max |got - ref| within 1e-4 * max(1, max |ref|) (ref in float64)."""
    ref = ref.double().cpu()
    err = (got.double().cpu() - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    print(f"  [{name}] card vs CPU float64: max err {err:.3e}, tolerance "
          f"1e-4 * max(1, {scale:.3f}) = {TOL * scale:.3e}", flush=True)
    if not err <= TOL * scale:
        raise AssertionError(f"{name}: card vs CPU float64 max err {err}")
    return {"max_err": err, "scale": scale}


SD_PROMPT = "a stone church on a hill at dusk, 2 towers, oil painting"


def text_encoders(tmp, hub, init, edited):
    """(a) and (b) of phase 14: synthetic CLIP text and safety-checker
    snapshots at the published widths, the card's encoders against the
    port's CPU float64 run, their forward times; returns (record, the
    card's (uc, c), the safety snapshot's directory)."""
    import os

    from sige_torch.models.sd.clip import SD_V1_TEXT, FrozenCLIPEmbedder
    from sige_torch.models.sd.safety import (VIT_L14, SafetyChecker,
                                             preprocess_images)

    rec, secs = {}, _Seconds()
    clip_dir = os.path.join(hub, "models--openai--clip-vit-large-patch14",
                            "snapshots", "synthetic")
    secs("clip snapshot (49 408 tokens, 123 M weights) written",
         lambda: write_clip_snapshot(clip_dir, SD_V1_TEXT, clip_text_state(
             SD_V1_TEXT, 7), seed=7))
    emb = secs("FrozenCLIPEmbedder on the card (from the hub cache)",
               lambda: FrozenCLIPEmbedder(device="cuda"))
    emb64 = FrozenCLIPEmbedder(device="cpu", dtype=torch.float64)
    prompts = ["", SD_PROMPT]
    pair = emb(prompts)
    rec["clip"] = _close_to("clip text last_hidden_state", pair,
                            emb64(prompts))
    ids = torch.as_tensor(emb.tokenizer(prompts)["input_ids"], device="cuda")
    with torch.inference_mode(), fp32_scope():
        fwd_ms, _ = events_ms(lambda: emb.model(input_ids=ids), 20)
    call_ms, _ = events_ms(lambda: emb(prompts), 20)
    rec["clip"].update(params_m=sum(p.numel() for p in emb.model.parameters())
                       / 1e6, forward_ms=fwd_ms, encode_prompts_ms=call_ms,
                       tokens=int((ids[1] != emb.tokenizer.pad_token_id)
                                  .sum()) + 1)
    print(f"  [clip] {rec['clip']['params_m']:.1f} M, forward at batch 2: "
          f"{fwd_ms:.3f} ms (events, median of 20); encode_prompts(['', p]) "
          f"with tokenization {call_ms:.3f} ms; the prompt is "
          f"{rec['clip']['tokens']} tokens", flush=True)

    # the safety checker: ViT-L/14 at 224, a 768 projection, 17 concept and
    # 3 special-care embeddings; thresholds split a smooth image (trips)
    # from the noisy init image (does not), so the command line's samples,
    # edits of that image, are likely to pass and the PNGs it writes to
    # hold the image
    state = secs("safety checker weights (303 M) drawn",
                 lambda: safety_state(VIT_L14, 768, 9))
    yy, xx = np.mgrid[0:512, 0:512] / 511.0
    smooth = np.stack([yy, xx, 0.5 * (yy + xx)], -1).astype(np.float32)
    images = np.stack([smooth, (init + 1) / 2]).astype(np.float32)
    trunk = vision_trunk(state).cuda()
    with torch.inference_mode(), fp32_scope():
        pv = preprocess_images(images, device="cuda").permute(0, 3, 1, 2)
        embeds = trunk(pv).pooler_output @ \
            state["visual_projection.weight"].cuda().T
    rec["safety_cosines"] = split_thresholds(state, embeds)
    del trunk
    safety_dir = os.path.join(tmp, "safety-checker")
    secs("safety snapshot written", lambda: write_safety_snapshot(
        safety_dir, VIT_L14, 768, state))
    del state
    checker = secs("SafetyChecker.from_pretrained onto the card",
                   lambda: SafetyChecker.from_pretrained(safety_dir,
                                                         device="cuda"))
    checker64 = SafetyChecker.from_pretrained(safety_dir, device="cpu",
                                              dtype=torch.float64)
    with torch.inference_mode(), fp32_scope():
        pooled = checker.vision_fn(preprocess_images(images, device="cuda"))
        pooled64 = checker64.vision_fn(preprocess_images(images,
                                                         device="cpu"))
    rec["safety"] = _close_to("safety pooled features", pooled, pooled64)
    _, verdict = checker(images)
    _, verdict64 = checker64(images)
    print(f"  [safety] verdicts (smooth image, init image): card {verdict}, "
          f"CPU float64 {verdict64}; cosines with concept 0 "
          f"{rec['safety_cosines']}", flush=True)
    if verdict != [True, False] or verdict64 != verdict:
        raise AssertionError(f"safety verdicts {verdict} / {verdict64}, "
                             f"expected [True, False]")
    one = images[1:]
    with torch.inference_mode(), fp32_scope():
        pv = preprocess_images(one, device="cuda")
        vis_ms, _ = events_ms(lambda: checker.vision_fn(pv), 20)
    check_ms, _ = events_ms(lambda: checker(one), 20)
    rec["safety"].update(
        params_m=sum(p.numel() for p in checker.vision.parameters()) / 1e6,
        vision_forward_ms=vis_ms, check_ms=check_ms, verdicts=verdict)
    print(f"  [safety] {rec['safety']['params_m']:.1f} M, vision forward at "
          f"batch 1: {vis_ms:.3f} ms (events, median of 20); the whole "
          f"check of one 512^2 sample with preprocessing {check_ms:.3f} ms",
          flush=True)
    rec["seconds"] = dict(secs)
    uc, c = pair[:1].cpu().numpy(), pair[1:].cpu().numpy()
    del emb, emb64, checker, checker64
    gc.collect()
    torch.cuda.empty_cache()
    return rec, (uc, c), safety_dir


def vision_trunk(state, cfg=None):
    """The port's CLIP vision trunk with the weights of a
    :func:`safety_state` (``cfg`` defaults to ViT-L/14)."""
    from sige_torch.models.sd.safety import VIT_L14, CLIPVisionModel

    trunk = CLIPVisionModel(cfg or VIT_L14)
    trunk.load_state_dict({k[len("vision_model."):]: v
                           for k, v in state.items()
                           if k.startswith("vision_model.")}, strict=True)
    return trunk.eval()


def kv_cache_unet(flash, runner, args, masks, seen, first_row):
    """(d) of phase 14: the SD U-Net with ``kv_cache_min_tokens=1024``
    (the 64^2 and 32^2 levels take the K/V caches) beside the default
    window chain, on the CLI run's plan; returns (record, kernel rows at
    the new flash shapes)."""
    import dataclasses

    from sige_torch.models.sd import SIGESDUNet
    from sige_torch.nn import SIGEModel

    cfg = dataclasses.replace(runner.unet_cfg, kv_cache_min_tokens=1024)
    kv = SIGEModel(SIGESDUNet(cfg), layout="window", device="cuda")
    kv.module.load_state_dict(runner.unet.module.state_dict())
    a0, a1 = args
    full = kv.full(*a0)
    kv.set_masks(masks)
    base_full = runner.unet.full(*a0)
    runner.unet.set_masks(masks)
    exact = _exact_scaled("sd unet kv", kv, a0, a1, full)
    same = (full - base_full).abs().max().item()
    print(f"  [sd unet kv] full forward against the default's: max err "
          f"{same:.3e}", flush=True)
    latent = a0[0].shape[1]
    rec = {"exact": exact, "full_vs_default": same}
    for name, model in (("default", runner.unet), ("kv", kv)):
        rec[name] = {mode: forward_row(
            flash, f"sd unet {name}", model, a0 if mode == "full" else a1,
            mode, sd_unet_calls(model, latent, mode))
            for mode in ("full", "sparse")}
    recorded = record_flash_calls({"unet kv": (kv, args)})
    rows = []
    with fp32_scope():
        for key, (where, bias) in recorded.items():
            if key in seen:
                continue
            B, N, M, H, D, masked = key
            label = (f"{row_label(first_row + len(rows))}: SD {where} "
                     f"{'K/V-cached self' if M > 77 else 'cross'}-attention "
                     f"(B {B}, N {N}, M {M}, H {H}, D {D})")
            rows.append(kernel_row(flash, label, B, N, M, H, D, bias))
    del kv
    torch.cuda.empty_cache()
    return rec, rows


def _exact_scaled(name, model, a0, a1, full):
    """sparse(x0) = full(x0) within 1e-4 * max(1, max|full|), also after a
    sparse(x1)."""
    errs = [(model.sparse(*a0) - full).abs().max().item()]
    edited = model.sparse(*a1)
    errs.append((model.sparse(*a0) - full).abs().max().item())
    scale = max(1.0, full.abs().max().item())
    moved = (edited - full).abs().max().item()
    print(f"  [{name}] sparse(x0) vs full(x0): max err {errs[0]:.3e}; after "
          f"a sparse(x1) (which moved the output by {moved:.3e}): "
          f"{errs[1]:.3e}; tolerance {TOL * scale:.3e}", flush=True)
    if not all(e <= TOL * scale for e in errs):
        raise AssertionError(f"{name}: sparse(x0) != full(x0): {errs}")
    return {"max_err": errs[0], "max_err_after_edit": errs[1],
            "scale": scale}


def tile_chain_decoder(flash, runner, args, dec_masks):
    """(e) of phase 14: the decoder at 512^2 in the tile layout with and
    without ``tile_chain``, beside the runner's window layout, on the CLI
    run's plan."""
    import dataclasses

    from sige_torch.models.sd import SIGEDecoder
    from sige_torch.nn import SIGEModel

    a0, a1 = args
    rec, outs = {}, {}
    for chain in (True, False):
        name = f"sd decoder tiles chain{int(chain)}"
        cfg = dataclasses.replace(runner.vae_cfg, tile_chain=chain)
        model = SIGEModel(SIGEDecoder(cfg), layout="tiles", device="cuda")
        model.module.load_state_dict(runner.decoder.module.state_dict())
        full = model.full(*a0)
        model.set_masks(dec_masks)
        rec[name] = {"exact": _exact_scaled(name, model, a0, a1, full)}
        outs[chain] = model.sparse(*a1)
        rec[name]["sparse"] = forward_row(
            flash, name, model, a1, "sparse", sd_vae_calls(model, "sparse"))
        del model
        torch.cuda.empty_cache()
    err = (outs[True] - outs[False]).abs().max().item()
    scale = max(1.0, outs[False].abs().max().item())
    print(f"  [sd decoder tiles] chained vs unchained on one edit and plan: "
          f"max err {err:.3e}, tolerance {TOL * scale:.3e}", flush=True)
    if not err <= TOL * scale:
        raise AssertionError(f"tile chain: chained != unchained ({err})")
    rec["chained_vs_unchained"] = {"max_err": err, "scale": scale}
    runner.decoder.full(*a0)
    runner.decoder.set_masks(dec_masks)
    rec["sd decoder window"] = {"sparse": forward_row(
        flash, "sd decoder window", runner.decoder, a1, "sparse",
        sd_vae_calls(runner.decoder, "sparse"))}
    return rec


def phase_sd_text(flash, tmp, seen, first_row):
    """Phase 14: SD from a text prompt and the SD models' last options, at
    full width, over phase 13's SD reference checkpoint in ``tmp``;
    ``seen``: the flash call keys earlier phases held against the plain
    version; new kernel rows are labelled from ``first_row`` on. Returns
    (record, new kernel rows)."""
    import os

    from sige_torch.cli import sd as sd_cli

    torch.cuda.reset_peak_memory_stats()
    pth = os.path.join(tmp, "sd-v1.ckpt")
    hub = os.path.join(tmp, "hub")
    saved_env = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = hub
    try:
        init, edited, _ = sd_cli.synthetic_inputs(512, 512, 0)
        rec, (uc, c), safety_dir = text_encoders(tmp, hub, init, edited)
        peaks = [torch.cuda.max_memory_allocated() / 2**20]
        emb = os.path.join(tmp, "prompt-embeddings.npz")
        np.savez(emb, uc=uc, c=c)
        t_enc = int(SD_STRENGTH * SD_STEPS)
        cli, runner = {}, None
        for name, extra in (("prompt", ["--prompt", SD_PROMPT]),
                            ("embeddings", ["--embeddings", emb])):
            if runner is not None:
                del runner
                gc.collect()
                torch.cuda.empty_cache()
            flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
            runner, out, secs = _run_cli(sd_cli.main, [
                "--task", "sdedit", "--synthetic", *extra, "--safety_model",
                safety_dir, "--restore_from", pth, "--ddim_steps",
                str(SD_STEPS), "--strength", str(SD_STRENGTH), "--scale",
                str(SD_GUIDANCE), "--save_dir", os.path.join(tmp, name),
                "--device", "cuda"])
            got = (flash.flash_mha.launches, flash.flash_mha.combine_launches)
            want = expected_counts(flash, sdedit_calls(sd_model_calls(runner),
                                                       t_enc))
            flagged = "NSFW concept detected" in out
            print(f"  [cli.sd --{name}] {secs:.3f} s; flash launches "
                  f"{got[0]} + {got[1]} (expected {want[0]} + {want[1]}); "
                  f"safety verdict: "
                  f"{'flagged, blacked out' if flagged else 'clean'}",
                  flush=True)
            if got != want:
                raise AssertionError(f"cli.sd --{name}: launches {got}, "
                                     f"expected {want}")
            _expect_lines(f"cli.sd --{name}", out, r"^saved .*sdedit\.png$")
            if "WARNING: no --safety_model" in out:
                raise AssertionError("cli.sd skipped the safety check")
            cli[name] = {"s": secs, "launches": got, "nsfw": flagged}
            peaks.append(torch.cuda.max_memory_allocated() / 2**20)
        pngs = [open(os.path.join(tmp, n, "sdedit.png"), "rb").read()
                for n in ("prompt", "embeddings")]
        if pngs[0] != pngs[1]:
            raise AssertionError("cli.sd: --prompt and --embeddings wrote "
                                 "different PNGs")
        print(f"  [cli.sd] --prompt and --embeddings PNGs identical "
              f"({len(pngs[0])} bytes)", flush=True)
        rec["cli"] = cli
        os.remove(pth)

        # (d) and (e) on the last CLI run's models and plans
        masks, dec_masks = runner.edit_masks(init, edited)
        x0, x1 = runner._image(init), runner._image(edited)
        z0, z1 = runner.encode(x0), runner.encode(x1, mode="sparse")
        t = torch.full((2,), 501.0, device="cuda")
        ctx = torch.cat([runner._tensor(uc), runner._tensor(c)])
        unet_args = ((torch.cat([z0, z0]), t, ctx),
                     (torch.cat([z1, z1]), t, ctx))
        rec["kv_cache"], rows = kv_cache_unet(flash, runner, unet_args, masks,
                                              seen, first_row)
        peaks.append(torch.cuda.max_memory_allocated() / 2**20)
        dec_args = ((runner._pre_decode(z0),), (runner._pre_decode(z1),))
        rec["tile_chain"] = tile_chain_decoder(flash, runner, dec_args,
                                               dec_masks)
        peaks.append(torch.cuda.max_memory_allocated() / 2**20)
    finally:
        if saved_env is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved_env
    rec["peak_mb"] = max(peaks + [
        r[m]["peak_mb"] for r in (rec["kv_cache"]["default"],
                                  rec["kv_cache"]["kv"])
        for m in ("full", "sparse")])
    print(f"  [sd text] peak device memory in phase 14: "
          f"{rec['peak_mb']:.0f} MB", flush=True)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return rec, rows


# --- phase 15: the engine's options -----------------------------------------

OPTIONS_SLOTS = 25  # the demo's cache slots (one per step)
OPTIONS_ITERS = 20  # timed sparse forwards per setting
OPTIONS_MAX_SESSIONS = 16  # bf16 sessions filled at most
OPTIONS_HEADROOM_MIB = 2048  # free memory kept for a forward's temporaries
CONTRACT_TOL = 1e-5  # bf16 storage against fp32 storage of the same values


def image_masks(original, edited, eps, dilate, min_res, dilation=None):
    """The runners' mask pyramid of an image pair ([H, W, C] numpy): the
    difference mask over ``eps``, dilated by ``dilate``, downsampled to
    ``min_res`` (with ``dilation`` per level where given)."""
    from sige_torch.core.masks import (compute_difference_mask, dilate_mask,
                                       downsample_mask)

    mask = dilate_mask(compute_difference_mask(original, edited, eps=eps),
                       dilate)
    kw = {} if dilation is None else {"dilation": dilation}
    return downsample_mask(mask, min_res=min_res, **kw)


def ddpm_edit(cfg, pair):
    """(x0, x1, mask pyramid) of an image pair in [0, 1] as
    ``DiffusionRunner.preprocess`` plans it (``DiffusionRunConfig()``)."""
    from sige_torch.runners import DiffusionRunConfig, data_transform

    rc = DiffusionRunConfig()
    o, e = (data_transform(a[None], rc.rescaled) for a in pair)
    masks = image_masks(o[0], e[0], rc.eps, rc.mask_dilate_radius,
                        cfg.resolution // 2 ** (len(cfg.ch_mult) - 1))
    return (torch.as_tensor(o, device="cuda"),
            torch.as_tensor(e, device="cuda"), masks)


def over(edited, pair):
    """``edited`` with ``pair``'s edit (where its two images differ) on
    top: a second edit over a committed one."""
    return np.where(pair[1] != pair[0], pair[1], edited)


def cache_dtype_sessions(model, x0, ts, session_mib):
    """Fill sessions of ``len(ts)`` slots (one full pass each) on
    ``model`` while the card's free memory holds another session of
    ``session_mib`` plus :data:`OPTIONS_HEADROOM_MIB` for a forward's
    temporaries, up to :data:`OPTIONS_MAX_SESSIONS`; returns (sessions,
    peak MB, free MB left, seconds per session)."""
    states, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    def free_mib():  # free device memory plus the allocator's unused cache
        return (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
                - torch.cuda.memory_allocated()) / 2**20

    while len(states) < OPTIONS_MAX_SESSIONS:
        if free_mib() < session_mib + OPTIONS_HEADROOM_MIB:
            break
        state = model.new_state()
        model.use(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, t in enumerate(ts):
            model.full(x0, t, cache_id=k)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        states.append(state)
    peak = torch.cuda.max_memory_allocated() / 2**20
    return states, peak, free_mib(), secs


def options_cache_dtype(flash):
    """(a) of phase 15: ``cache_dtype`` on the church256 DDPM U-Net with
    the demo's 25 slots."""
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.nn import SIGEModel

    cfg = DDPMUNetConfig(cache_slots=OPTIONS_SLOTS)
    module = SIGEFusedUNet(cfg)
    x0, x1, masks = ddpm_edit(cfg, edit_pair(cfg.resolution))
    ts = [torch.full((1,), 16.0 * k, device="cuda")
          for k in range(OPTIONS_SLOTS)]
    rec = {}
    for dtype in (None, torch.bfloat16):
        name = "bf16" if dtype else "fp32"
        model = SIGEModel(module, layout="tiles", bucket_min=DEMO_BUCKET_MIN,
                          cache_dtype=dtype, device="cuda")
        if dtype is None:
            model.init(0)
        for k, t in enumerate(ts):
            model.full(x0, t, cache_id=k)
        slot = _storage_mb(model.state.tensors(0))
        session = _storage_mb(model.state.tensors())
        rec[name] = {"slot_mib": slot, "session_mib": session}
        print(f"  [cache_dtype {name}] {slot:.1f} MiB per slot, "
              f"{session:.1f} MiB a session of {OPTIONS_SLOTS} slots",
              flush=True)
        if dtype is None:
            del model
            gc.collect()
            torch.cuda.empty_cache()
    ratio = rec["bf16"]["slot_mib"] / rec["fp32"]["slot_mib"]
    print(f"  [cache_dtype] bf16 / fp32 per slot: {ratio:.4f}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    states, peak, left, secs = cache_dtype_sessions(
        model, x0, ts, rec["bf16"]["session_mib"])
    total = torch.cuda.get_device_properties(0).total_memory / 2**20
    print(f"  [cache_dtype bf16] {len(states)} sessions of {OPTIONS_SLOTS} "
          f"filled slots held (at most {OPTIONS_MAX_SESSIONS}; another "
          f"needs {rec['bf16']['session_mib']:.0f} + "
          f"{OPTIONS_HEADROOM_MIB} MiB, {left:.0f} MiB free), peak "
          f"{peak:.0f} MiB of {total:.0f}, {np.median(secs):.2f} s to fill "
          f"a session", flush=True)
    if len(states) < 2:
        raise AssertionError("cache_dtype: fewer than two bf16 sessions fit")
    rec.update(ratio=ratio, sessions=len(states), sessions_peak_mib=peak,
               free_mib_left=left, session_fill_s=secs)
    del states, model
    gc.collect()
    torch.cuda.empty_cache()

    # the sparse forward with bf16 caches against fp32 ones, and the
    # contract: bf16 storage = fp32 storage of the same rounded values
    t = ts[0]
    want = expected_launches(flash, cfg, 1)
    rec["sparse"] = {}
    for layout in ("window", "tiles"):
        wide = SIGEModel(module, layout=layout, device="cuda")
        narrow = SIGEModel(module, layout=layout, device="cuda",
                           cache_dtype=torch.bfloat16)
        for m in (wide, narrow):
            m.full(x0, t)
        for name, slots in narrow.state.caches.items():
            for key, v in slots[0].items():
                if v.dtype == torch.bfloat16:
                    wide.state.caches[name][0][key] = v.float()
        row = {}
        outs = {}
        for name, m in (("fp32", wide), ("bf16", narrow)):
            m.set_masks(masks)
            if m.active_layout != layout:
                raise AssertionError(f"cache_dtype: ran {m.active_layout}")
            outs[name], got = counted(
                flash, f"{layout} {name} sparse forward",
                lambda m=m: m.sparse(x1, t), want)
            for _ in range(3):
                m.sparse(x1, t)
            median, p90 = events_ms(lambda m=m: m.sparse(x1, t),
                                    OPTIONS_ITERS)
            row[name] = {"median_ms": median, "p90_ms": p90,
                         "flash_launches": got["launches"],
                         "kernel_launches": launches_per_forward(
                             lambda m=m: m.sparse(x1, t))}
        err = (outs["bf16"] - outs["fp32"]).abs().max().item()
        scale = max(1.0, outs["fp32"].abs().max().item())
        print(f"  [cache_dtype {layout}] sparse median ms: bf16 "
              f"{row['bf16']['median_ms']:.3f} (p90 "
              f"{row['bf16']['p90_ms']:.3f}) "
              f"against fp32 {row['fp32']['median_ms']:.3f} (p90 "
              f"{row['fp32']['p90_ms']:.3f}); kernel launches "
              f"{row['bf16']['kernel_launches']:.1f} against "
              f"{row['fp32']['kernel_launches']:.1f}; bf16 storage vs fp32 "
              f"storage of the same values: max err {err:.3e} (tolerance "
              f"{CONTRACT_TOL * scale:.3e})", flush=True)
        if not err <= CONTRACT_TOL * scale:
            raise AssertionError(f"cache_dtype {layout}: {err:.3e}")
        row["contract_err"] = err
        rec["sparse"][layout] = row
        del wide, narrow
        torch.cuda.empty_cache()
    return rec


def slot_sequence(flash, name, model, args, edit1, edit2, calls, seen):
    """Phase 15 (b) on one model: a full pass per slot (``args[k]``), the
    first edit (``edit1`` = (masks, args)) committed into the last slot,
    a second edit over it, then slot 0's replay (its original under the
    second plan; with one slot, the committed edit under its own plan),
    within 1e-4 * max(1, max|ref|). Every forward's flash launches are
    held to ``calls(mode, update)``; flash calls not in ``seen`` are
    returned for kernel rows."""
    last = len(args) - 1
    new, fulls, rec = {}, [], {}
    for k, a in enumerate(args):
        out, _ = counted(flash, f"{name} full, slot {k}",
                         lambda a=a, k=k: model.full(*a, cache_id=k),
                         expected_counts(flash, calls("full", False)))
        fulls.append(out)
    model.set_masks(edit1[0])
    before = [[id(t) for t in model.state.tensors(k)]
              for k in range(last + 1)]
    upd_calls = calls("sparse", True)
    (upd, got), found = record_calls(
        lambda: counted(flash, f"{name} sparse_update, slot {last}",
                        lambda: model.sparse(*edit1[1], cache_id=last,
                                             sparse_update=True),
                        expected_counts(flash, upd_calls)),
        seen, f"{name} sparse_update")
    new.update(found)
    if any([id(t) for t in model.state.tensors(k)] != before[k]
           for k in range(last)):
        raise AssertionError(f"{name}: the commit touched another slot")
    if [id(t) for t in model.state.tensors(last)] == before[last]:
        raise AssertionError(f"{name}: the commit wrote nothing")
    rec["update"] = {"launches": got["launches"],
                     "combine_launches": got["combine_launches"],
                     "moved": (upd - fulls[last]).abs().max().item()}
    rec["update"]["kernel_launches"] = launches_per_forward(
        lambda: model.sparse(*edit1[1], cache_id=last, sparse_update=True))
    rec["default_kernel_launches"] = launches_per_forward(
        lambda: model.sparse(*edit1[1], cache_id=last))
    model.set_masks(edit2[0])
    (second, got), found = record_calls(
        lambda: counted(flash, f"{name} second edit over the commit",
                        lambda: model.sparse(*edit2[1], cache_id=last),
                        expected_counts(flash, calls("sparse", False))),
        seen, f"{name} second edit")
    new.update(found)
    for o in [upd, second] + fulls:
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}: a non-finite output")
    rec["second"] = {"launches": got["launches"],
                     "combine_launches": got["combine_launches"]}
    median, p90 = events_ms(lambda: model.sparse(*edit2[1], cache_id=last),
                            OPTIONS_ITERS)
    rec["second"].update(median_ms=median, p90_ms=p90)
    if last:
        replay = model.sparse(*args[0], cache_id=0)
        ref, what = fulls[0], "slot 0: sparse(x0) = full(x0)"
    else:
        model.set_masks(edit1[0])
        replay = model.sparse(*edit1[1], cache_id=0)
        ref, what = upd, "the committed edit replays under its plan"
    err = (replay - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    print(f"  [{name}] {what}: max err {err:.3e} (tolerance "
          f"{TOL * scale:.3e}); the commit moved the output by "
          f"{rec['update']['moved']:.3e}; kernel launches per forward: "
          f"sparse_update {rec['update']['kernel_launches']:.1f}, without "
          f"{rec['default_kernel_launches']:.1f}; second edit "
          f"{median:.3f} ms median (p90 {p90:.3f})", flush=True)
    if not err <= TOL * scale:
        raise AssertionError(f"{name}: {what}: {err:.3e}")
    rec["replay_err"] = err
    return rec, new


def options_slots(flash, seen):
    """(b) of phase 15: two cache slots and ``sparse_update`` on the PD
    U-Net, the SD U-Net (latent 64^2, guidance batch 2), the SD encoder
    and decoder at 512^2, and one slot on GauGAN fused and sub-mobile at
    512x256; random weights from seed 0 (GauGAN's BatchNorm statistics
    calibrated on the original)."""
    from sige_torch.models.gaugan import (SIGESubMobileSPADEGenerator,
                                          SPADEGenConfig, decode_config)
    from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
    from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                      SIGEEncoder, SIGESDUNet)
    from sige_torch.nn import SIGEModel
    from sige_torch.runners import (GauGANRunConfig, GauGANRunner,
                                    SDRunConfig, data_transform)

    rec, new = {}, {}

    def run(name, model, args, edit1, edit2, calls):
        rec[name], found = slot_sequence(flash, name, model, args, edit1,
                                          edit2, calls, seen)
        new.update(found)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    # PD: slot k at its own logsnr, the DDPM paths' edits
    cfg = PDUNetConfig(cache_slots=2)
    R = cfg.resolution
    original, edited = edit_pair(R)
    edited2 = over(edited, second_edit(R))
    o, e, e2 = (data_transform(a[None], True) for a in
                (original, edited, edited2))
    min_res = R // 2 ** (len(cfg.ch_mult) - 1)
    m1 = image_masks(o[0], e[0], 1e-2, 5, min_res)
    m2 = image_masks(e[0], e2[0], 1e-2, 5, min_res)
    model = SIGEModel(SIGEPDUNet(cfg), layout="window", device="cuda")
    model.init(0)
    x0, x1, x2 = (torch.as_tensor(a, device="cuda") for a in (o, e, e2))
    ls = [torch.full((1,), v, device="cuda") for v in (2.5, -1.0)]
    pd_calls = pd_attention_calls(cfg)
    run("pd", model, [(x0, ls[0]), (x0, ls[1])], (m1, (x1, ls[1])),
        (m2, (x2, ls[1])), lambda mode, update: pd_calls)

    # SD: the U-Net on latents, the VAE on images and latents at 512^2
    rc = SDRunConfig()
    unet_cfg = SDUNetConfig(cache_slots=2)
    vae_cfg = SDVAEConfig(resolution=512, cache_slots=2)
    R = vae_cfg.resolution
    f = 2 ** (len(vae_cfg.ch_mult) - 1)  # the VAE's downsampling factor
    L = R // f
    original, edited = edit_pair(R)
    edited2 = over(edited, second_edit(R))
    o, e, e2 = (2.0 * a - 1.0 for a in (original, edited, edited2))
    diff1 = image_masks(o, e, rc.mask_eps, rc.mask_dilate_radius,
                        rc.mask_min_res, 1)
    diff2 = image_masks(e, e2, rc.mask_eps, rc.mask_dilate_radius,
                        rc.mask_min_res, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def latent_edit(z, img_a, img_b):
        """``z`` with fresh values where the images differ (f x f
        blocks)."""
        m = torch.as_tensor(np.abs(img_a - img_b).max(-1) > 0,
                            device="cuda")
        m = m.reshape(L, f, L, f).any(3).any(1)[None, :, :, None]
        return torch.where(m, torch.randn(z.shape, generator=gen,
                                          device="cuda"), z)

    z0 = [torch.randn(1, L, L, vae_cfg.z_channels, generator=gen,
                      device="cuda") for _ in range(2)]
    z1 = latent_edit(z0[1], o, e)
    z2 = latent_edit(z1, e, e2)
    ctx = torch.randn(2, 77, unet_cfg.context_dim, generator=gen,
                      device="cuda")
    ts = [torch.full((2,), v, device="cuda") for v in (501.0, 301.0)]
    two = lambda z: torch.cat([z, z])  # noqa: E731 (the guidance batch)
    model = SIGEModel(SIGESDUNet(unet_cfg), layout="window", device="cuda")
    model.init(0)
    run("sd unet", model, [(two(z0[0]), ts[0], ctx), (two(z0[1]), ts[1],
                                                        ctx)],
        (diff1, (two(z1), ts[1], ctx)), (diff2, (two(z2), ts[1], ctx)),
        lambda mode, update, m=model: sd_unet_calls(m, L, mode, update))

    imgs = [torch.as_tensor(a[None], device="cuda") for a in (o, e, e2)]
    model = SIGEModel(SIGEEncoder(vae_cfg), layout="window", device="cuda")
    model.init(0)
    other = torch.rand(imgs[0].shape, generator=gen, device="cuda") * 2 - 1
    run("sd encoder", model, [(other,), (imgs[0],)], (diff1, (imgs[1],)),
        (diff2, (imgs[2],)),
        lambda mode, update, m=model: sd_vae_calls(m, mode, update))

    def dec_masks(a, b):
        from sige_torch.core.masks import (compute_difference_mask,
                                           dilate_mask, downsample_mask)

        diff = dilate_mask(compute_difference_mask(a, b, eps=rc.mask_eps),
                           rc.mask_dilate_radius)
        return downsample_mask(dilate_mask(diff, rc.decoder_dilate_radius),
                               min_res=(4, 4), dilation=0)

    model = SIGEModel(SIGEDecoder(vae_cfg), layout="window", device="cuda")
    model.init(0)
    run("sd decoder", model, [(z0[0],), (z0[1],)],
        (dec_masks(o, e), (z1,)), (dec_masks(e, e2), (z2,)),
        lambda mode, update, m=model: sd_vae_calls(m, mode, update))

    # GauGAN, fused and sub-mobile: one slot (the config has none)
    gcfg = SPADEGenConfig()
    grc = GauGANRunConfig()
    labels = gaugan_edit_pair(gcfg)
    labels2 = over(labels[1], gaugan_second_edit(gcfg))
    for name, module in (("gaugan", None), ("gaugan sub-mobile",
                                            SIGESubMobileSPADEGenerator(
                                                gcfg, tuple(decode_config(
                                                    SUB_MOBILE_CONFIG))))):
        runner = GauGANRunner(gcfg, module=module, layout="window",
                              device="cuda", seed=0)
        s0, s1, s2 = (runner.preprocess_input(lab)
                      for lab in (labels[0], labels[1], labels2))
        calibrate_bn_stats(runner, s0)
        gm = [image_masks(a[0], b[0], grc.mask_eps, grc.mask_dilate_radius,
                          gcfg.latent_hw, grc.downsample_dilate_radius)
              for a, b in ((s0, s1), (s1, s2))]
        x = [torch.as_tensor(a, device="cuda") for a in (s0, s1, s2)]
        model = runner.model
        del runner
        run(name, model, [(x[0],)], (gm[0], (x[1],)), (gm[1], (x[2],)),
            lambda mode, update: [])
    return rec, new


def options_pins(flash):
    """(c) of phase 15: ``pin_capacities`` and ``merge_pins`` in the tile
    layout on the church256 DDPM U-Net."""
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.nn import SIGEModel, merge_pins, plan_pins

    cfg = DDPMUNetConfig()
    R = cfg.resolution
    module = SIGEFusedUNet(cfg)
    t = torch.full((1,), 100.0, device="cuda")
    big = ddpm_edit(cfg, edit_pair(R, frac=0.06, at=(60, 60)))
    smalls = [ddpm_edit(cfg, edit_pair(R, frac=f, at=at))
              for f, at in ((0.006, (150, 30)), (0.008, (30, 170)),
                            (0.007, (170, 150)), (0.009, (100, 200)))]

    def new_edit(model, x1, masks):
        """Host seconds of a new edit's plan and sparse forward, and of
        its repeat."""
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.set_masks(masks)
            model.sparse(x1, t)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    rec = {"unpinned": [], "pinned": []}
    # exact capacities (no buckets), so an unpinned new edit has new shapes
    free = SIGEModel(module, layout="tiles", bucket_min=1, device="cuda")
    free.init(0)
    pinned = SIGEModel(module, layout="tiles", bucket_min=1, device="cuda")
    x0 = big[0]
    free.full(x0, t)
    pinned.full(x0, t)
    pinned.set_masks(big[2])
    pinned.sparse(big[1], t)  # times the pinned shapes once
    pins = pinned.pin_capacities()
    for i, (_, x1, masks) in enumerate(smalls):
        model, kind = (free, "unpinned") if i % 2 == 0 else (pinned,
                                                             "pinned")
        first, again = new_edit(model, x1, masks)
        rec[kind].append(first - again)
        if kind == "pinned" and plan_pins(model.plan_host) != pins:
            raise AssertionError("pins: a smaller edit changed the shapes")
        print(f"  [pins] {kind} new edit {i}: {first:.3f} s, repeat "
              f"{again:.3f} s, extra {first - again:.3f} s", flush=True)
    # the pinned plan computes what the unpinned one does
    _, x1, masks = smalls[1]
    free.set_masks(masks)
    pinned.set_masks(masks)
    y_free, y_pin = free.sparse(x1, t), pinned.sparse(x1, t)
    err = (y_free - y_pin).abs().max().item()
    med = {n: events_ms(lambda m=m: m.sparse(x1, t), OPTIONS_ITERS)[0]
           for n, m in (("unpinned", free), ("pinned", pinned))}
    print(f"  [pins] {len(pins)} pins; pinned vs unpinned output on one "
          f"edit: max err {err:.3e}; sparse median ms: pinned "
          f"{med['pinned']:.3f}, unpinned {med['unpinned']:.3f}", flush=True)
    if not err <= TOL:
        raise AssertionError(f"pins: pinned != unpinned ({err:.3e})")
    rec.update(pins=len(pins), pinned_vs_unpinned=err, sparse_ms=med)

    # merge_pins over two sessions' plans feeding one set_masks each
    states, outs, plans = [free.new_state(), free.new_state()], [], []
    for state, (_, x1, masks) in zip(states, (big, smalls[0])):
        free.use(state)
        free.full(x0, t)
        plans.append(free.set_masks(masks))
        outs.append(free.sparse(x1, t))
    merged = merge_pins(*(plan_pins(p) for p in plans))
    errs = []
    for state, (_, x1, masks), want in zip(states, (big, smalls[0]), outs):
        free.use(state)
        if plan_pins(free.set_masks(masks, capacities=merged)) != merged:
            raise AssertionError("merge_pins: a plan missed the merged pins")
        errs.append((free.sparse(x1, t) - want).abs().max().item())
    print(f"  [pins] merge_pins over two sessions: both plans take the "
          f"merged shapes; outputs against their own plans' max err "
          f"{max(errs):.3e}", flush=True)
    if not max(errs) <= TOL:
        raise AssertionError(f"merge_pins: {errs}")
    rec["merge_err"] = max(errs)
    del free, pinned, states
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_engine_options(flash, seen, first_row):
    """Phase 15: the engine's options at full width: (a) ``cache_dtype``,
    (b) cache slots and ``sparse_update`` on PD, SD and GauGAN, (c)
    ``pin_capacities`` and ``merge_pins``; ``seen``: the flash call keys
    already held against the plain version; new kernel rows are labelled
    from ``first_row`` on. Returns (record, new kernel rows)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = {"cache_dtype": options_cache_dtype(flash)}
    rec["slots"], new = options_slots(flash, seen)
    rec["pins"] = options_pins(flash)
    rows = []
    with fp32_scope():
        for (B, N, M, H, D, masked), (where, bias) in new.items():
            label = (f"{row_label(first_row + len(rows))}: {where} "
                     f"{'masked ' if masked else ''}attention (B {B}, N {N}, "
                     f"M {M}, H {H}, D {D})")
            rows.append(kernel_row(flash, label, B, N, M, H, D, bias))
    rec["s"] = time.perf_counter() - t0
    print(f"  [options] phase 15 in {rec['s']:.1f} s, {len(rows)} new flash "
          f"shapes", flush=True)
    return rec, rows


# --- phase 16: the quality path ---------------------------------------------

def metric_weights(tmp, seed: int = 0):
    """Synthetic checkpoints of the metric backbones at their published
    widths, in the published files' layouts, written into ``tmp``:
    torchvision ``alexnet`` (``features.*``) and ``inception_v3`` (with
    its ``fc`` head, which the converter drops), the lpips ``alex.pth``
    lins (``lin<i>.model.1.weight``, uniform in [0, 1)) and the
    DataParallel ``drn-d-105_ms_cityscapes.pth`` (``module.`` prefix, the
    frozen ``up.weight``); values from ``seeded_state`` (which keeps the
    DRN's logits ~1e1, so that 1e-4 * max|ref| is a limit that a loss of
    precision fails). Returns {flag name: path}."""
    import os

    from sige_torch.metrics.backbones import (AlexNetFeatures, DRNSeg,
                                              InceptionV3Features)
    from sige_torch.metrics.backbones.alexnet import CHANNELS
    from sige_torch.metrics.backbones.common import seeded_state
    from sige_torch.metrics.backbones.drn import _bilinear_up_kernel

    with torch.device("meta"):
        alex, inception, drn = AlexNetFeatures(), InceptionV3Features(), DRNSeg()
    gen = torch.Generator().manual_seed(seed + 3)
    weights = {
        "backbone_weights": seeded_state(alex, seed),
        "lpips_weights": {f"lin{i}.model.1.weight":
                          torch.rand((1, c, 1, 1), generator=gen)
                          for i, c in enumerate(CHANNELS)},
        "inception_weights": dict(
            seeded_state(inception, seed + 1),
            **{"fc.weight": 0.01 * torch.randn((1000, 2048), generator=gen),
               "fc.bias": torch.zeros(1000)}),
        "drn_weights": dict(
            {f"module.{k}": v for k, v in seeded_state(drn, seed + 2).items()},
            **{"module.up.weight": torch.from_numpy(
                _bilinear_up_kernel(16)).expand(19, 1, 16, 16).clone()}),
    }
    paths = {}
    for flag, sd in weights.items():
        paths[flag] = os.path.join(tmp, f"{flag}.pth")
        torch.save(sd, paths[flag])
    return paths


def _rel_err(name, got, ref, tol):
    """|got - ref| / |ref| within ``tol``, printed; returns it."""
    rel = abs(got - ref) / abs(ref)
    print(f"    {name}: card {got:.9g}, CPU {ref:.9g}, relative "
          f"{rel:.3e} (tolerance {tol:.0e})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{name}: relative {rel:.3e} > {tol:.0e}")
    return rel


def on_cpu_float64(wrapper):
    """A shallow copy of a metric wrapper whose module is a float64 copy
    on the CPU (the wrappers read their device and dtype from it)."""
    import copy

    ref = copy.copy(wrapper)
    ref.module = copy.deepcopy(wrapper.module).to("cpu", torch.float64)
    return ref


def tf32_control(name, module, x, refs):
    """The control of (a)'s limit: ``module(x)`` on the card with TF32
    allowed in cuDNN's convs and CUDA's matmuls (outside the engine's
    fp32 scope), against the CPU float64 outputs ``refs`` (NHWC, or
    [B, F]) that the fp32 run was held to. It has to miss 1e-4 * max(1,
    max|ref|) on some output: then the limit sees the precision that the
    scope holds. The caller's flags come back. Returns the worst
    error over its limit."""
    saved = precision_flags()
    set_precision_flags(("tf32", "tf32", *saved[2:]))
    try:
        with torch.inference_mode():
            out = module(x)
    finally:
        set_precision_flags(saved)
    ratios = []
    for o, r in zip(out if isinstance(out, (list, tuple)) else [out], refs):
        o = o.double().cpu()
        o = o.permute(0, 2, 3, 1) if o.ndim == 4 else o
        r = torch.as_tensor(np.asarray(r)).double().reshape(o.shape)
        scale = max(1.0, r.abs().max().item())
        ratios.append((o - r).abs().max().item() / (TOL * scale))
    print(f"    {name} TF32 control: max err / limit {max(ratios):.2f} over "
          f"{len(ratios)} output(s) (must exceed 1)", flush=True)
    if not max(ratios) > 1:
        raise AssertionError(f"{name}: TF32 stays within the limit; it "
                             f"cannot tell fp32 from TF32")
    return max(ratios)


def backbone_row(name, module, x, iters: int = 20):
    """ms per forward of ``module(x)`` on CUDA events (median of ``iters``
    after 3 warm-ups), its GMACs (``FlopCounterMode`` / 2), kernel
    launches and busy ms per forward (a profiler trace) and peak MB."""
    from torch.utils.flop_counter import FlopCounterMode

    from sige_torch.metrics.backbones.common import run

    fwd = lambda: run(module, x)  # noqa: E731
    for _ in range(3):
        fwd()
    median, p90 = events_ms(fwd, iters)
    with FlopCounterMode(display=False) as fc:
        fwd()
    busy, launches = trace_stats(fwd, iters=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd()
    torch.cuda.synchronize()
    row = {"input": list(x.shape), "ms": median, "p90_ms": p90,
           "gmacs": fc.get_total_flops() / 2e9, "launches": launches,
           "busy_ms": busy,
           "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
    print(f"  [quality {name}] forward {tuple(x.shape)}: {median:.3f} ms "
          f"median (p90 {p90:.3f}, n={iters}), {row['gmacs']:.3f} GMACs, "
          f"{launches} kernel launches, busy {busy} ms, peak "
          f"{row['peak_mb']:.1f} MB", flush=True)
    return row


def quality_backbones(weights):
    """(a) of phase 16: each backbone at its published width on the card
    against the port's CPU float64 run of the same module, on seeded
    inputs: AlexNet's LPIPS taps on a 256^2 pair and their distance;
    ``FIDInception`` on 16 images of 256^2 (up to 299) and 8 of 512^2
    (down to 299) and the FID between the two sets; ``DRNSeg`` on
    GauGAN's 512x256 output size, its logits and labels. Each backbone's
    TF32 control then has to miss the limit (:func:`tf32_control`)."""
    from sige_torch.metrics import (LPIPS, compute_fid, frechet_distance,
                                    gaussian_stats)
    from sige_torch.metrics.backbones import CityscapesSegmenter, FIDInception
    from sige_torch.metrics.backbones.alexnet import LPIPS_SCALE, LPIPS_SHIFT
    from sige_torch.metrics.backbones.common import nchw
    from sige_torch.metrics.backbones.inception import resize_299
    from sige_torch.metrics.lpips import lpips_from_features
    from sige_torch.utils.convert import load_torch_state_dict

    rng = np.random.default_rng(16)
    out = {}

    # AlexNet: the LPIPS taps and distance on a 256^2 pair (church256)
    lp = LPIPS(weights["backbone_weights"], weights["lpips_weights"],
               device="cuda")._impl
    ref = on_cpu_float64(lp)
    a = rng.random((256, 256, 3)).astype(np.float32) * 2 - 1
    b = a.copy()
    b[96:160, 80:176] = rng.random((64, 96, 3)) * 2 - 1
    taps = {k: (m.features(a), m.features(b)) for k, m in (("card", lp),
                                                           ("cpu", ref))}
    errs = [_close_to(f"quality alexnet tap {i} ({t.shape[-1]} ch)",
                      torch.from_numpy(t), torch.from_numpy(
                          taps["cpu"][j][i]))["max_err"]
            for j in range(2) for i, t in enumerate(taps["card"][j])]
    d = {k: lpips_from_features(*v, lp.lins) for k, v in taps.items()}
    x = nchw(((a - LPIPS_SHIFT) / LPIPS_SCALE)[None], lp.module)
    out["alexnet"] = dict(
        backbone_row("alexnet", lp.module, x), max_err=max(errs), lpips=d,
        lpips_rel=_rel_err("LPIPS distance", d["card"], d["cpu"], 1e-5),
        tf32_over_limit=tf32_control("alexnet", lp.module, x,
                                     taps["cpu"][0]))

    # InceptionV3: 16 images of 256^2 and 8 of 512^2 to 299, and their FID
    fi = FIDInception(load_torch_state_dict(weights["inception_weights"]),
                      device="cuda")
    ref = on_cpu_float64(fi)
    sets = [rng.random((16, 256, 256, 3)).astype(np.float32),
            rng.random((8, 512, 512, 3)).astype(np.float32)]
    feats = {k: [m(s) for s in sets] for k, m in (("card", fi),
                                                  ("cpu", ref))}
    errs = [_close_to(f"quality inception from {s.shape[1]}^2",
                      torch.from_numpy(feats["card"][i]),
                      torch.from_numpy(feats["cpu"][i]))["max_err"]
            for i, s in enumerate(sets)]
    fid = {k: frechet_distance(*gaussian_stats(f[0]), *gaussian_stats(f[1]))
           for k, f in feats.items()}
    if compute_fid(*sets, fi) != fid["card"]:
        raise AssertionError("compute_fid differs from its own statistics")
    x = resize_299(nchw(sets[1], fi.module)) * 2.0 - 1.0
    out["inception"] = dict(
        backbone_row("inception", fi.module, x), max_err=max(errs), fid=fid,
        fid_rel=_rel_err("FID (16 x 256^2 against 8 x 512^2)", fid["card"],
                         fid["cpu"], 1e-3),
        tf32_over_limit=tf32_control("inception", fi.module, x,
                                     [feats["cpu"][1]]))
    del fi, ref, feats

    # DRN-D-105: GauGAN's 512x256 output
    seg = CityscapesSegmenter(load_torch_state_dict(weights["drn_weights"]),
                              device="cuda")
    ref = on_cpu_float64(seg)
    img = rng.random((256, 512, 3)).astype(np.float32)
    logits = {k: m.logits(img)[0].permute(1, 2, 0).cpu().numpy()
              for k, m in (("card", seg), ("cpu", ref))}
    err = _close_to("quality drn logits (256x512)",
                    *map(torch.from_numpy, (logits["card"],
                                            logits["cpu"])))["max_err"]
    top2 = np.sort(logits["cpu"], axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3 * np.abs(logits["cpu"]).max()
    labels = {k: v.argmax(-1) for k, v in logits.items()}
    if not np.array_equal(seg(img), labels["card"]):
        raise AssertionError("drn: the segmenter's labels are not its "
                             "logits' argmax")
    differ = int((labels["card"] != labels["cpu"])[clear].sum())
    print(f"    drn labels: {differ} of {int(clear.sum())} clear pixels "
          f"differ ({clear.size - int(clear.sum())} near-ties set aside)",
          flush=True)
    if differ:
        raise AssertionError(f"drn: {differ} labels differ away from ties")
    x = nchw(((img - seg.MEAN) / seg.STD)[None], seg.module)
    out["drn"] = dict(backbone_row("drn", seg.module, x), max_err=err,
                      clear_share=float(clear.mean()), labels_differ=differ,
                      tf32_over_limit=tf32_control("drn", seg.module, x,
                                                   [logits["cpu"]]))
    del seg, ref
    torch.cuda.empty_cache()
    return out


def _sdedit_dataset(root, R: int = 256, n: int = 2):
    """The reference SDEdit layout: ``original/``, ``edited/`` and
    ``gt/`` (the originals) with matching names, seeded random images
    each edited in a square of ~1.2% of the canvas; raw Cityscapes label
    maps in ``labels/``."""
    import os

    from sige_torch.data import save_image

    rng = np.random.default_rng(17)
    side = int(round((0.012 * R * R) ** 0.5))
    for i in range(n):
        original = rng.random((R, R, 3)).astype(np.float32)
        edited = original.copy()
        r, c = (1 + i) * R // 4, R // 3
        edited[r:r + side, c:c + side] = rng.random((side, side, 3))
        name = f"{i:03d}.png"
        for sub, img in (("original", original), ("edited", edited),
                         ("gt", original)):
            save_image(os.path.join(root, sub, name), img)
        os.makedirs(os.path.join(root, "labels"), exist_ok=True)
        np.save(os.path.join(root, "labels", f"{i:03d}.npy"),
                rng.integers(0, 34, (R, R)))


def quality_golden(flash, tmp, weights):
    """(c) of phase 16: ``cli.golden --family ddpm`` at church256 full
    width: a reference-layout fused checkpoint served over a ``file://``
    mirror (its md5 patched into the registry spec, downloads allowed for
    the call), a 2-image SDEdit dataset, PSNR, LPIPS and FID with the
    synthetic backbones; the md5-verified fetch, the generated files, the
    scored list and the flash launches of the two generates."""
    import hashlib
    import os

    from sige_torch.cli import golden
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.utils import registry

    cfg = DDPMUNetConfig()
    name = "church256-ddpm-fused_unet.pth"
    mirror = os.path.join(tmp, "mirror", name)
    os.makedirs(os.path.dirname(mirror))
    with torch.device("meta"):
        layout = reference_layout("ddpm", SIGEFusedUNet(cfg))
    torch.save(reference_values(layout, 16), mirror)
    with open(mirror, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    data_root = os.path.join(tmp, "church_outdoor_sdedit")
    _sdedit_dataset(data_root, cfg.resolution)
    save_dir, pretrained = (os.path.join(tmp, d)
                            for d in ("results", "pretrained"))
    spec = registry.REGISTRY[name]
    registry.REGISTRY[name] = registry.CheckpointSpec(
        name, md5, "file://" + mirror, spec.converter)
    env = os.environ.get("SIGE_TPU_ALLOW_DOWNLOAD")
    os.environ["SIGE_TPU_ALLOW_DOWNLOAD"] = "1"
    try:
        flash.flash_mha.launches = flash.flash_mha.combine_launches = 0
        scored, out, secs = _run_cli(golden.main, [
            "--family", "ddpm", "--data_root", data_root,
            "--save_dir", save_dir, "--pretrained_root", pretrained,
            "--mirror", "file://" + mirror, "--metrics", "psnr,lpips,fid",
            "--backbone_weights", weights["backbone_weights"],
            "--lpips_weights", weights["lpips_weights"],
            "--inception_weights", weights["inception_weights"],
            "--device", "cuda", "--",
            "--hparams", f"sampling.sample_steps={STEPS}"])
        counts = (flash.flash_mha.launches, flash.flash_mha.combine_launches)
    finally:
        registry.REGISTRY[name] = spec
        if env is None:
            del os.environ["SIGE_TPU_ALLOW_DOWNLOAD"]
        else:
            os.environ["SIGE_TPU_ALLOW_DOWNLOAD"] = env
    with open(os.path.join(pretrained, name), "rb") as f:
        fetched_md5 = hashlib.md5(f.read()).hexdigest()
    files = sorted(os.listdir(save_dir))
    want = tuple(2 * n for n in expected_launches(flash, cfg))
    print(f"  [quality golden] {secs:.2f} s; fetched md5 {fetched_md5} "
          f"(registry {md5}); wrote {files}; scored {scored}; flash "
          f"launches {counts[0]} + {counts[1]} combine (expected {want[0]} "
          f"+ {want[1]}: two generates)", flush=True)
    if fetched_md5 != md5:
        raise AssertionError("golden: the fetched checkpoint's md5 differs")
    if files != ["000.png", "001.png", "index.html"]:
        raise AssertionError(f"golden: wrote {files}")
    _expect_lines("golden", out, r"^\[golden\] scored: \['psnr', 'lpips', "
                  r"'fid'\]", r"^PSNR: [\d.]+ over 2 images$",
                  r"^LPIPS: [\d.]+ over 2 images$", r"^FID: [\d.]+$")
    if counts != want:
        raise AssertionError(f"golden: flash launches {counts}, expected "
                             f"{want}")
    return {"s": secs, "scored": scored, "launches": counts[0],
            "combine_launches": counts[1], "files": files,
            "md5": fetched_md5}, save_dir, data_root


def quality_get_metric(save_dir, data_root, weights):
    """(b) of phase 16: ``cli.get_metric`` on the card over (c)'s DDPM
    images against their originals (PSNR with ``--mask_root``, LPIPS,
    FID, and mIoU through the DRN against raw label maps), each line and
    its wall seconds, held to an in-process ``--device cpu`` run of the
    same command: PSNR and mIoU lines equal, LPIPS within 1e-4 and FID
    within 1e-3 relative."""
    import os

    from sige_torch.cli import get_metric
    from sige_torch.core.masks import compute_difference_mask, dilate_mask
    from sige_torch.data import load_image

    masks = os.path.join(data_root, "masks")
    os.makedirs(masks)
    for name in sorted(os.listdir(os.path.join(data_root, "original"))):
        a, b = (load_image(os.path.join(data_root, sub, name))
                for sub in ("original", "edited"))
        np.save(os.path.join(masks, name.replace(".png", ".npy")),
                dilate_mask(compute_difference_mask(a, b, eps=0.01), 5))
    base = ["--root", save_dir, "--gt_root", os.path.join(data_root, "gt")]
    runs = {
        "psnr": ["--metric", "psnr", *base, "--mask_root", masks],
        "lpips": ["--metric", "lpips", *base, "--backbone_weights",
                  weights["backbone_weights"], "--lpips_weights",
                  weights["lpips_weights"]],
        "fid": ["--metric", "fid", *base, "--inception_weights",
                weights["inception_weights"]],
        "miou": ["--metric", "miou", "--root", save_dir, "--gt_root",
                 os.path.join(data_root, "labels"), "--drn_weights",
                 weights["drn_weights"]],
    }
    out = {}
    for metric, argv in runs.items():
        res = {}
        for device in ("cuda", "cpu"):
            value, line, secs = _run_cli(get_metric.main,
                                         argv + ["--device", device])
            res[device] = {"value": value, "line": line.strip(), "s": secs}
        print(f"  [quality get_metric] {metric}: card {res['cuda']['s']:.2f} "
              f"s, CPU {res['cpu']['s']:.2f} s", flush=True)
        card, cpu = res["cuda"]["value"], res["cpu"]["value"]
        if metric in ("psnr", "miou"):
            if res["cuda"]["line"] != res["cpu"]["line"]:
                raise AssertionError(f"get_metric {metric}: card "
                                     f"{res['cuda']['line']!r} != CPU "
                                     f"{res['cpu']['line']!r}")
        else:
            res["rel"] = _rel_err(f"get_metric {metric}", card, cpu,
                                  1e-4 if metric == "lpips" else 1e-3)
        out[metric] = res
    return out


def phase_quality(flash):
    """Phase 16: the quality path at the published widths on the card;
    synthetic backbone checkpoints and the golden run's files in a
    temporary directory. Returns its record."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sige-quality-") as tmp:
        weights = metric_weights(tmp)
        rec = {"backbones": quality_backbones(weights)}
        rec["golden"], save_dir, data_root = quality_golden(flash, tmp,
                                                            weights)
        rec["get_metric"] = quality_get_metric(save_dir, data_root, weights)
    rec["s"] = time.perf_counter() - t0
    print(f"  [quality] phase 16 in {rec['s']:.1f} s", flush=True)
    return rec


def one_phase(flash, name: str) -> dict:
    """The record of one phase run alone, as ``--phase`` selects it."""
    import tempfile

    if name == "checkpoints":
        return phase_checkpoints(flash)
    if name == "sd_text":
        with tempfile.TemporaryDirectory(prefix="sige-sd-text-") as tmp:
            ckpt = checkpoint_sd(flash, tmp, _Seconds())
            result, rows = phase_sd_text(flash, tmp, set(), 25)
        return {"checkpoint_sd": ckpt, "sd_text": result, "rows": rows}
    if name == "engine_options":
        result, rows = phase_engine_options(flash, set(), 27)
        return {"options": result, "rows": rows}
    return {"quality": phase_quality(flash)}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Smoke run of the port on one "
                                "NVIDIA GPU (every phase, or one).")
    p.add_argument("--phase", choices=("checkpoints", "sd_text",
                                       "engine_options", "quality"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.phase:
        from sige_torch.ops import flash

        t0 = time.perf_counter()
        print(f"card: {card_line()} | torch {torch.__version__} cuda "
              f"{torch.version.cuda}", flush=True)
        flash.LIBRARY.load()
        result = one_phase(flash, args.phase)
        print(f"elapsed: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps(result, default=str), flush=True)
        return 0
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)
    defaults = precision_flags()
    print(f"precision flags (cuDNN conv, matmul, cudnn.benchmark) as "
          f"PyTorch set them: {defaults}; the paths run under them (the "
          f"engine holds fp32 and benchmark mode for its forwards), the "
          f"kernel phases inside the engine's fp32 scope", flush=True)

    from sige_torch.ops import flash

    t0 = time.perf_counter()
    flash.LIBRARY.load()
    print(f"build: {FLASH_SOURCE} in {time.perf_counter() - t0:.2f} s "
          f"-> {flash.LIBRARY.path}", flush=True)
    print(flash.LIBRARY.build_log.strip(), flush=True)

    print("kernels:", flush=True)
    with fp32_scope():
        rows = phase_kernels(flash)
        print("forced splits at (a):", flush=True)
        forced, combine = phase_forced_splits(flash)
    print("small reference:", flush=True)
    phase_small_reference()
    from sige_torch.runners import DiffusionRunConfig

    ddim = DiffusionRunConfig(sampler_type="ddim", eta=0.0,
                              sample_steps=STEPS, noise_level=500)
    dpm = DiffusionRunConfig(sampler_type="dpm_solver",
                             algorithm_type="dpmsolver++", order=2,
                             solver_type="dpmsolver", lower_order_final=True,
                             sample_steps=STEPS, noise_level=500)
    print("retime (cuDNN benchmark mode per new edit, DDPM main path):",
          flush=True)
    retime = phase_retime(flash, ddim)
    print("paths (church256, full width):", flush=True)
    paths = {
        "main": phase_path(flash, "main", None, "window", ddim, 100),
        "tiles": phase_path(flash, "tiles", "tiles", "tiles", ddim, 100),
        "dpm_solver": phase_path(flash, "dpm_solver", None, "window", dpm, 0),
    }
    print("sd (SD v1 U-Net, VAE at 512^2, full width):", flush=True)
    sd, recorded = phase_sd(flash)
    print("kernels at the SD path's shapes:", flush=True)
    with fp32_scope():
        rows += phase_sd_kernels(flash, recorded)
    print("pd (church pd256, full width):", flush=True)
    pd, pd_recorded = phase_pd(flash)
    print("kernels at the PD path's shapes:", flush=True)
    with fp32_scope():
        rows += phase_pd_kernels(flash, pd_recorded,
                                       chr(ord("a") + len(rows)))
    print("gaugan (Cityscapes SPADE generator at 512x256, full width):",
          flush=True)
    gaugan = phase_gaugan(flash)
    print("demo (church256 at full width: per-step cache slots, sessions, "
          "the HTTP server):", flush=True)
    demo = phase_demo(flash)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="sige-ckpt-") as tmp:
        print("checkpoints and command lines (reference layouts at full "
              "width, cli.diffusion, cli.gaugan, cli.sd):", flush=True)
        ckpt = phase_checkpoints(flash, tmp)
        print("sd text path and options (CLIP and the safety checker at "
              "their published widths, cli.sd --prompt --safety_model, the "
              "U-Net's K/V caches, the decoder's tile chain):", flush=True)
        sd_text, text_rows = phase_sd_text(
            flash, tmp, set(recorded) | set(pd_recorded), len(rows))
    rows += text_rows
    print("engine options (cache_dtype on the demo's 25 slots, slots and "
          "sparse_update on PD, SD and GauGAN, pin_capacities and "
          "merge_pins, full width):", flush=True)
    options, option_rows = phase_engine_options(
        flash, {(r["B"], r["N"], r["M"], r["H"], r["D"], r["bias"])
                for r in rows}, len(rows))
    rows += option_rows
    print("quality path (LPIPS, FID and mIoU backbones at their published "
          "widths, cli.get_metric, cli.golden --family ddpm at church256):",
          flush=True)
    quality = phase_quality(flash)
    if precision_flags() != defaults:
        raise AssertionError(f"precision flags {precision_flags()} after the "
                             f"run, {defaults} before it")

    main_row = rows[0]  # shape (a): the main path's 16 px call
    kernels = [{
        "name": "flash_attn_fwd_f32",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "tpu_kernel": "sige_tpu/ops/flash.py:_fwd_kernel (flash_mha_bhsd)",
        "kernels": FLASH_KERNELS,
        "launches": paths["main"]["launches"],
        "combine_launches": paths["main"]["combine_launches"],
        "launches_by_path": dict(
            {n: p["launches"] for n, p in paths.items()},
            sd_sdedit=sd["launches"], pd_generate=pd["launches"],
            gaugan_generate=gaugan["launches"],
            **{f"demo_{s}_{r}": demo[s]["requests"][r]["launches"]
               for s in ("ddim", "dpm_solver")
               for r in demo[s]["requests"]},
            cli_ddpm_generate=ckpt["ddpm"]["flash_counts"]["generate_pth"][0],
            cli_pd_generate=ckpt["pd"]["flash_counts"][0],
            cli_sd_sdedit=ckpt["sd"]["flash_counts"][0],
            cli_sd_prompt=sd_text["cli"]["prompt"]["launches"][0],
            golden_ddpm=quality["golden"]["launches"],
            sd_unet_kv_sparse=sd_text["kv_cache"]["kv"]["sparse"][
                "launches"],
            **{f"options_{n.replace(' ', '_')}_{k}": r[k]["launches"]
               for n, r in options["slots"].items()
               for k in ("update", "second")}),
        "combine_launches_by_path": dict(
            {n: p["combine_launches"] for n, p in paths.items()},
            sd_sdedit=sd["combine_launches"],
            pd_generate=pd["combine_launches"],
            gaugan_generate=gaugan["combine_launches"],
            **{f"demo_{s}_{r}": demo[s]["requests"][r]["combine_launches"]
               for s in ("ddim", "dpm_solver")
               for r in demo[s]["requests"]}),
        "splits": main_row["splits"],
        "max_abs_err": max([r["max_err"] for r in rows]
                           + [f["max_err"] for f in forced.values()]
                           + [f["max_err_vs_plain_split"]
                              for f in forced.values()]),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "device_ms": main_row["kernel_device_ms"],
        "plain_device_ms": main_row["plain_device_ms"],
        "library_device_ms": main_row["library_device_ms"],
        "shapes": rows,
        "forced_splits_a": {str(s): f for s, f in forced.items()},
        "combine_a": combine,
    }]
    print(json.dumps({"paths": paths, "retime": retime, "sd": sd, "pd": pd,
                      "gaugan": gaugan, "demo": demo, "checkpoints": ckpt,
                      "sd_text": sd_text, "options": options,
                      "quality": quality, "card": card}),
          flush=True)
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
