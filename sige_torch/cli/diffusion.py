"""Diffusion suite CLI (reference: diffusion/test.py) — the port of
``sige_tpu.cli.diffusion``.

  python -m sige_torch.cli.diffusion --config_path configs/church_ddpm256-sige.yml \
      --mode profile --synthetic
  python -m sige_torch.cli.diffusion --config_path ... --mode generate \
      --data_root database/church_outdoor_sdedit --save_dir results/ \
      --restore_from church256-ddpm-fused_unet.pth --save_converted ckpt/

``--restore_from`` takes a reference ``.pth`` (converted here) or a
directory written by ``--save_converted``. It runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..utils.checkpoint import restore
from .common import add_device_flag, profile, profile_line, tiles, trace


def get_args(argv=None):
    p = argparse.ArgumentParser(description="SIGE-torch diffusion benchmarks")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--mode", choices=("generate", "profile"), default="generate")
    p.add_argument("--hparams", type=str, default="",
                   help='dot-path overrides, e.g. "sampling.eps=0.02"')
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--image_metas", type=str, nargs="+", default=None)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--restore_from", type=str, default=None,
                   help="reference .pth checkpoint to convert, or a native "
                        "checkpoint dir written by --save_converted")
    p.add_argument("--save_converted", type=str, default=None,
                   help="write the (converted) weights as a native "
                        "checkpoint dir, which later runs load as they are")
    p.add_argument("--synthetic", action="store_true",
                   help="run on a synthetic edit pair (no dataset needed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup_times", type=int, default=20)
    p.add_argument("--test_times", type=int, default=100)
    p.add_argument("--trace", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the profile "
                        "loop to this directory")
    add_device_flag(p)
    return p.parse_args(argv)


def build_runner(config, restore_from=None, device=None):
    m = config.model
    if m.get("network", "").startswith("pd"):
        return _build_pd_runner(config, restore_from, device)
    return _build_ddpm_runner(config, restore_from, device)


def _build_pd_runner(config, restore_from=None, device=None):
    from ..models.pd import PDUNetConfig
    from ..nn.engine import resolve_device
    from ..runners import PDRunConfig, PDRunner
    from ..utils.convert import convert_pd_unet

    device = resolve_device(device)
    m, s = config.model, config.sampling
    model_cfg = PDUNetConfig(
        ch=m.ch, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions), in_ch=m.in_ch,
        out_ch=m.out_ch, resolution=config.data.image_size,
        temb_ch=m.get("temb_ch", 768), head_dim=m.get("head_dim", 64),
        num_heads=m.get("num_heads"), num_groups=m.get("num_groups", 32),
        logsnr_input_type=m.get("logsnr_input_type", "inv_cos"),
        block_size_normal=(m.get("sige_block_size") or {}).get("normal", 6),
        block_size_instance=(m.get("sige_block_size") or {}).get("instance", 4),
        sparse_resolution_threshold=m.get("sparse_resolution_threshold", 64),
    )
    run_cfg = PDRunConfig(
        total_steps=s.total_steps, sample_steps=s.sample_steps,
        noise_level=s.noise_level, skip_type=s.get("skip_type", "uniform"),
        eps=s.get("eps", 2e-2),
        mask_dilate_radius=s.get("mask_dilate_radius", 2),
        rescaled=config.data.get("rescaled", True),
    )
    params = restore(restore_from, lambda sd: convert_pd_unet(
        sd, ch_mult=model_cfg.ch_mult,
        num_res_blocks=model_cfg.num_res_blocks,
        attn_resolutions=model_cfg.attn_resolutions,
        resolution=model_cfg.resolution), device) if restore_from else None
    return PDRunner(model_cfg, run_cfg, params=params, device=device)


def _build_ddpm_runner(config, restore_from=None, device=None):
    from ..models.ddpm import DDPMUNetConfig
    from ..nn.engine import resolve_device
    from ..runners import DiffusionRunConfig, DiffusionRunner
    from ..utils.convert import (convert_ddpm_fused_unet,
                                 convert_ddpm_unet_to_fused)

    device = resolve_device(device)
    m, s = config.model, config.sampling
    model_cfg = DDPMUNetConfig(
        ch=m.ch, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions), in_ch=m.in_ch,
        out_ch=m.out_ch, resolution=config.data.image_size,
        num_groups=m.get("num_groups", 32),
        block_size_normal=m.get("sige_block_size", {}).get("normal", 6),
        block_size_instance=m.get("sige_block_size", {}).get("instance", 4),
        sparse_resolution_threshold=m.get("sparse_resolution_threshold", 64),
    )
    run_cfg = DiffusionRunConfig(
        sampler_type=s.sampler_type, total_steps=s.total_steps,
        sample_steps=s.sample_steps, noise_level=s.noise_level,
        beta_schedule=s.beta_schedule, beta_start=s.beta_start,
        beta_end=s.beta_end, eta=s.get("eta", 0.0),
        skip_type=s.get("skip_type", "uniform"), eps=s.get("eps", 1e-2),
        mask_dilate_radius=s.get("mask_dilate_radius", 5),
        rescaled=config.data.get("rescaled", True),
        algorithm_type=s.get("algorithm_type", "dpmsolver++"),
        order=s.get("order", 2), solver_type=s.get("solver_type", "dpmsolver"),
        lower_order_final=s.get("lower_order_final", True),
    )
    # The runner always drives the fused arch (dense mode == the vanilla
    # network; sige_torch.models.ddpm.VanillaDDPMUNet): a vanilla
    # checkpoint (network "ddpm.unet") goes through the temb/qkv-fusing
    # surgery (reference: fused_unet.py:306-355).
    network = m.get("network", "ddpm.fused_unet")
    convert = (convert_ddpm_unet_to_fused if network.endswith(".unet")
               else convert_ddpm_fused_unet)
    params = restore(restore_from, lambda sd: convert(
        sd, ch_mult=model_cfg.ch_mult,
        num_res_blocks=model_cfg.num_res_blocks,
        attn_resolutions=model_cfg.attn_resolutions,
        resolution=model_cfg.resolution), device) if restore_from else None
    return DiffusionRunner(model_cfg, run_cfg, params=params, device=device)


def synthetic_pair(resolution, seed=0, edit_pct=1.2):
    rng = np.random.default_rng(seed)
    original = rng.random((resolution, resolution, 3)).astype(np.float32)
    edited = original.copy()
    side = max(2, int(round((edit_pct / 100 * resolution**2) ** 0.5)))
    r = resolution // 2 - side // 2
    edited[r : r + side, r : r + side] = rng.random((side, side, 3))
    return original, edited


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    runner."""
    args = get_args(argv)
    from ..utils.config import load_config, override_config

    config = load_config(args.config_path)
    if args.hparams:
        override_config(config, args.hparams)

    runner = build_runner(config, args.restore_from, args.device)
    if args.save_converted:
        from ..utils.checkpoint import save_params

        print("saved native checkpoint:",
              save_params(args.save_converted, runner.module.state_dict()))

    if args.synthetic:
        pairs = [("synthetic", *synthetic_pair(config.data.image_size, args.seed))]
    else:
        from ..data import SDEditDataset

        root = args.data_root or config.data.data_root
        ds = SDEditDataset(root, args.image_metas)
        pairs = [(d["name"], d["original"], d["edited"]) for d in ds]

    if args.mode == "profile":
        with trace(args.trace, runner.device):
            for name, original, edited in pairs:
                stats = profile(runner, original, edited,
                                args.warmup_times, args.test_times)
                print(profile_line(name, stats))
        return runner

    from ..data import save_image

    rows = []
    for name, original, edited in pairs:
        t0 = time.perf_counter()
        out = runner.generate(original, edited, seed=args.seed)
        dt = time.perf_counter() - t0
        # per-image log line (reference: diffusion/runner.py:236-245)
        print(f"Image {name}: Edit Ratio "
              f"{100 * runner.last_edit_ratio:.2f}%    "
              f"Tiles {tiles(runner.model)}    Time {dt:.2f}s")
        if args.save_dir:
            path = os.path.join(args.save_dir, f"{name}.png")
            save_image(path, out)
            rows.append({"name": name, "generated": path})
            print(f"saved {path}")
    if args.save_dir and rows:
        from ..utils.html import write_gallery

        write_gallery(os.path.join(args.save_dir, "index.html"), rows)
    return runner


if __name__ == "__main__":
    main()
