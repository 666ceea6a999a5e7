"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card   — the card's name and power limit (nvidia-smi); exits non-zero
            without a CUDA device;
2. build  — compiles every CUDA kernel of the port from ``sige_torch/csrc``
            with nvcc for sm_90a (into ``build/sige_torch/``), all at once;
3. kernels — holds each kernel against its plain PyTorch version at the
            main path's shapes and at synthetic SD shapes (a)-(e) (TF32 off for matmuls and
            convs, so the plain versions are true fp32), and times the
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
4. small  — a tiny U-Net on the card agrees with the same U-Net on the
            CPU, in the tile layout and in the window layout with chains;
5. paths  — the church256 DDPM SDEdit path at full width through
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
6. sd     — the Stable Diffusion SDEdit path at full width through
            ``sige_torch.runners.SDRunner`` (SD v1 U-Net with guidance 7.5
            at batch 2, the VAE at 512^2, 5 twin steps): ``sdedit`` with
            the launch counters set to 0 just before and read just after,
            held to the count derived from the config and the plans;
            sparse = full on the original for the encoder, U-Net and
            decoder, also after a sparse pass on the edit; per model and
            mode the launches, latency, GMACs and peak MB;
7. sd kernels — the flash kernel against its plain version at every
            distinct (B, N, M, H, D) the SD path's forwards give it, the
            masked rows with the biases the models built from their plans:
            (f) the decoder's mid attention, (g) its masked stale/fresh
            form, (h) the encoder's masked form, then each U-Net self-,
            cross- and masked self-attention.

The line before the last is the ``kernels`` JSON; the last line is the
device JSON.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

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


def device_ms(fn, iters: int = 20, tries: int = 3):
    """Device kernel time of one call of ``fn``: the summed busy time of
    its kernels in a torch.profiler trace of ``iters`` calls, per call;
    returns (total ms, {kernel name: ms}). Now and then a trace holds no
    device activity at all; it is then taken again, up to ``tries``
    times."""
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
    raise AssertionError(f"the profiler recorded no device time in {tries} "
                         f"traces")


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
    dev = {n: device_ms(fn)[0] for n, fn in fns.items()}
    bound_ms, bound_by = attention_bound(B, N, M, H, D, bias is not None)
    print(f"  {label}: S={splits}  max err {err:.3e}  ms (events): "
          f"kernel {call['kernel']:.4f}  plain {call['plain']:.4f}  sdpa "
          f"{call['library']:.4f}  bound {bound_ms:.5f} ({bound_by}); "
          f"device ms (profiler): kernel {dev['kernel']:.4f}  plain "
          f"{dev['plain']:.4f}  sdpa {dev['library']:.4f}", flush=True)
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


def edit_pair(R: int):
    """The ``__graft_entry__._build`` edit: a square of ~1.2% of the canvas
    at (R/4, R/4) over a random image, both from default_rng(0)."""
    rng = np.random.default_rng(0)
    original = rng.random((R, R, 3)).astype(np.float32)
    edited = original.copy()
    side = max(4, int(round((0.012 * R * R) ** 0.5)))
    edited[R // 4: R // 4 + side, R // 4: R // 4 + side] = rng.random(
        (side, side, 3))
    return original, edited


def phase_small_reference():
    """A tiny U-Net on the card against the same U-Net on the CPU (the CPU
    port is the one the tests hold against sige_tpu), in the tile layout
    and in the window layout with chains."""
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.runners import DiffusionRunConfig, DiffusionRunner

    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(16,), resolution=32,
                         sparse_resolution_threshold=32)
    rc = DiffusionRunConfig(sampler_type="ddim")
    original, edited = edit_pair(32)
    for layout in ("tiles", "window"):
        outs = {}
        for dev in ("cpu", "cuda"):
            runner = DiffusionRunner(cfg, rc, layout=layout, device=dev,
                                     seed=0)
            x0, x1, _ = runner.preprocess(original, edited)
            if runner.active_layout != layout:
                raise AssertionError(f"ran {runner.active_layout}, asked "
                                     f"for {layout}")
            t = torch.full((1,), 17.0, device=dev)
            outs[dev] = [runner.model.full(x0, t).cpu(),
                         runner.model.sparse(x1, t).cpu()]
        err = max((a - b).abs().max().item()
                  for a, b in zip(outs["cpu"], outs["cuda"]))
        print(f"  tiny U-Net card vs CPU, {layout} (full, sparse): max err "
              f"{err:.3e}", flush=True)
        if not (err <= TOL):
            raise AssertionError(f"tiny U-Net card vs CPU ({layout}) max err "
                                 f"{err:.3e}")


STEPS = 5  # sampling steps of every full-width generate


def expected_launches(flash, cfg):
    """Attention and combine launches of one full-width ``generate``:
    5 attention calls at 16 px + 1 at 8 px per forward, one forward in
    preprocess plus two per step (DDIM and DPM-Solver alike)."""
    calls = {256: 5, 64: 1}  # sequence length -> calls; one head
    D = cfg.ch * cfg.ch_mult[-1]  # 512 at both levels
    forwards = 1 + 2 * STEPS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    combines = forwards * sum(
        n for seq, n in calls.items()
        if flash._num_splits(1, seq, seq, D, sms) > 1)
    return forwards * sum(calls.values()), combines


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
    result = {"layout": runner.active_layout, "launches": launches,
              "combine_launches": combines, "generate_s": gen_s,
              "profile": prof}
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


def sd_unet_calls(runner, mode):
    """(B, N, M, heads, D) of every flash call of one U-Net forward with
    guidance (batch 2): per transformer block a self-attention (masked
    stale/fresh in the window chain) and a cross-attention over 77
    tokens."""
    from sige_torch.models.sd import SIGESpatialTransformer

    cfg = runner.unet_cfg
    mods = [m for m in runner.unet.module.modules()
            if isinstance(m, SIGESpatialTransformer)]
    shapes = sd_transformer_shapes(cfg, runner.latent_hw[0])
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
            M = res * res + (N if masked and cfg.window_chain else 0)
        calls += [(2, N, M, H, ch // H), (2, N, 77, H, ch // H)] * len(
            m.blocks)
    return calls


def sd_vae_calls(model, mode):
    """The flash call of one encoder or decoder forward (the mid block's
    single-head attention)."""
    m = model.module.mid_attn
    cfg = model.module.cfg
    res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
    N = M = res * res
    if mode == "sparse":
        N, masked = _sparse_tokens(m.sparse_ok, m.gather, res)
        M = res * res + (N if masked and cfg.window_chain else 0)
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

    fwd = {"full": model.full, "sparse": model.sparse}[mode]
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
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fwd(*args)
        end.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    ctx = SIGECtx(mode=mode, macs=[])
    with torch.inference_mode():
        model.module(*args, ctx=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd(*args)
    torch.cuda.synchronize()
    res = {"launches": got[0], "combine_launches": got[1],
           "latency_ms": float(np.median(times)),
           "latency_p90_ms": float(np.percentile(times, 90)),
           "iters": iters, "macs_g": sum(ctx.macs) / 1e9,
           "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
    print(f"  [sd {name}] {mode}: {res['latency_ms']:.3f} ms median (p90 "
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
    calls = {(n, mode): (sd_unet_calls(runner, mode) if n == "unet"
                         else sd_vae_calls(m, mode))
             for n, m in models.items() for mode in ("full", "sparse")}
    path_calls = (calls["encoder", "full"] + calls["encoder", "sparse"]
                  + calls["unet", "full"] * (1 + t_enc)
                  + calls["unet", "sparse"] * t_enc
                  + calls["decoder", "full"] + calls["decoder", "sparse"])
    want, want_combines = expected_counts(flash, path_calls)
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

    prof = {n: {mode: forward_stats(flash, n, models[n], args[n][0]
                                    if mode == "full" else args[n][1], mode,
                                    calls[n, mode])
                for mode in ("full", "sparse")}
            for n in ("unet", "decoder", "encoder")}
    resident = {n: resident_mb(m) for n, m in models.items()}
    print("  [sd] resident (params + caches) MB: " + ", ".join(
        f"{n} {v:.1f}" for n, v in resident.items()), flush=True)

    result = {"sdedit_s": sdedit_s, "launches": launches,
              "combine_launches": combines, "twin_steps": t_enc,
              "params_m": params, "exact": exact, "profile": prof,
              "resident_mb": resident,
              "unet_calls": {m: len(calls["unet", m]) for m in
                             ("full", "sparse")}}
    del runner, models, args
    torch.cuda.empty_cache()
    return result, recorded


def record_flash_calls(models):
    """One full and one sparse forward of each model (``{name: (model,
    (full args, sparse args))}``) with the attention entry recording its
    flash calls: ``{(B, N, M, H, D, masked): (label, bias)}`` in the
    order of first call, each bias a copy of the one the model built."""
    from sige_torch.ops import attention

    real, seen = attention.flash_mha, {}
    for name, (model, (a0, a1)) in models.items():
        for mode, fwd, args in (("full", model.full, a0),
                                ("sparse", model.sparse, a1)):
            def rec(qh, kh, vh, scale, bias=None, where=f"{name} {mode}"):
                B, N, H, D = qh.shape
                key = (B, N, kh.shape[1], H, D, bias is not None)
                if key not in seen:
                    seen[key] = (where, None if bias is None
                                 else bias.clone())
                return real(qh, kh, vh, scale, bias=bias)

            attention.flash_mha = rec
            try:
                fwd(*args)
            finally:
                attention.flash_mha = real
    torch.cuda.synchronize()
    return seen


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convs: plain versions are fp32",
          flush=True)

    from sige_torch.ops import flash

    t0 = time.perf_counter()
    flash.LIBRARY.load()
    print(f"build: {FLASH_SOURCE} in {time.perf_counter() - t0:.2f} s "
          f"-> {flash.LIBRARY.path}", flush=True)
    print(flash.LIBRARY.build_log.strip(), flush=True)

    print("kernels:", flush=True)
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
    print("paths (church256, full width):", flush=True)
    paths = {
        "main": phase_path(flash, "main", None, "window", ddim, 100),
        "tiles": phase_path(flash, "tiles", "tiles", "tiles", ddim, 100),
        "dpm_solver": phase_path(flash, "dpm_solver", None, "window", dpm, 0),
    }
    print("sd (SD v1 U-Net, VAE at 512^2, full width):", flush=True)
    sd, recorded = phase_sd(flash)
    print("kernels at the SD path's shapes:", flush=True)
    rows += phase_sd_kernels(flash, recorded)

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
            sd_sdedit=sd["launches"]),
        "combine_launches_by_path": dict(
            {n: p["combine_launches"] for n, p in paths.items()},
            sd_sdedit=sd["combine_launches"]),
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
    print(json.dumps({"paths": paths, "sd": sd, "card": card}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
