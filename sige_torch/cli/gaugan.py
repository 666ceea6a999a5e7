"""GauGAN suite CLI (reference: gaugan/test.py) — the port of
``sige_tpu.cli.gaugan``.

  python -m sige_torch.cli.gaugan --netG sige_fused_spade --mode profile --synthetic
  python -m sige_torch.cli.gaugan --netG spade --restore_from spade.pth \
      --mode generate --synthetic --save_dir results/

The engine drives the fused generators; which converter reads a
``--restore_from`` checkpoint follows the checkpoint's own layout (per-norm
``mlp_shared`` convs: the unfused ``spade.pth`` / ``sub_mobile_spade-*``
layout, converted with the fusing surgery), so any ``--netG`` takes
either. It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import add_device_flag, profile, profile_line, tiles, trace

NETG = ("spade", "fused_spade", "sige_fused_spade", "sub_mobile_spade",
        "fused_sub_mobile_spade", "sige_fused_sub_mobile_spade")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="SIGE-torch GauGAN benchmarks")
    p.add_argument("--netG", type=str, default="sige_fused_spade",
                   choices=NETG)
    p.add_argument("--restore_from", type=str, default=None,
                   help="reference .pth checkpoint to convert, or a native "
                        "checkpoint dir written by --save_converted")
    p.add_argument("--save_converted", type=str, default=None,
                   help="write the (converted) weights as a native "
                        "checkpoint dir, which later runs load as they are")
    p.add_argument("--mode", choices=("generate", "profile"), default="generate")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--input_nc", type=int, default=35)
    p.add_argument("--num_upsampling_layers", type=str, default="more")
    p.add_argument("--config_str", type=str, default=None,
                   help="sub-mobile channel config, e.g. 32_32_32_48_32_24_24_32")
    p.add_argument("--main_block_size", type=int, default=6)
    p.add_argument("--shortcut_block_size", type=int, default=4)
    p.add_argument("--num_sparse_layers", type=int, default=5)
    p.add_argument("--mask_dilate_radius", type=int, default=1)
    p.add_argument("--downsample_dilate_radius", type=int, default=2)
    p.add_argument("--data_root", type=str, default="database/cityscapes-edit")
    p.add_argument("--crop_size", type=int, default=512)
    p.add_argument("--aspect_ratio", type=float, default=2.0)
    p.add_argument("--no_instance", action="store_true")
    p.add_argument("--no_symmetric_editing", action="store_true")
    p.add_argument("--image_ids", type=int, nargs="+", default=None)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup_times", type=int, default=20)
    p.add_argument("--test_times", type=int, default=100)
    p.add_argument("--trace", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run to "
                        "this directory")
    add_device_flag(p)
    return p.parse_args(argv)


def build_runner(args):
    """The :class:`GauGANRunner` for parsed flags, weights restored."""
    from ..models.gaugan import (SIGESubMobileSPADEGenerator, SPADEGenConfig,
                                 decode_config)
    from ..nn.engine import resolve_device
    from ..runners.gaugan_runner import GauGANRunConfig, GauGANRunner
    from ..utils import convert
    from ..utils.checkpoint import restore

    device = resolve_device(args.device)
    semantic_nc = args.input_nc + (0 if args.no_instance else 1)
    dense = not args.netG.startswith("sige")
    model_cfg = SPADEGenConfig(
        ngf=args.ngf, semantic_nc=semantic_nc, crop_size=args.crop_size,
        aspect_ratio=args.aspect_ratio,
        num_upsampling_layers=args.num_upsampling_layers,
        main_block_size=None if dense else args.main_block_size,
        shortcut_block_size=None if dense else args.shortcut_block_size,
        num_sparse_layers=0 if dense else args.num_sparse_layers,
    )
    run_cfg = GauGANRunConfig(
        input_nc=args.input_nc, use_instance=not args.no_instance,
        mask_dilate_radius=args.mask_dilate_radius,
        downsample_dilate_radius=args.downsample_dilate_radius,
    )
    module = channels = None
    if "sub_mobile" in args.netG:
        if not args.config_str:
            raise SystemExit("--config_str required for sub-mobile nets")
        channels = tuple(decode_config(args.config_str))
        module = SIGESubMobileSPADEGenerator(model_cfg, channels)
    def convert_checkpoint(sd):
        # The engine always drives the fused archs; unfused checkpoints go
        # through the mlp concatenation surgery (reference:
        # fused_spade_generator.py:72-160,
        # fused_sub_mobile_spade_generator.py:77-133).
        unfused = convert.is_unfused_spade(sd)
        if channels is not None:
            return convert.convert_gaugan_sub_mobile_spade(
                sd, channels=channels, ngf=args.ngf, fused_ckpt=not unfused)
        if unfused:
            return convert.convert_gaugan_spade(
                sd, args.num_upsampling_layers, fuse=True)
        return convert.convert_gaugan_fused_spade(
            sd, args.num_upsampling_layers)

    params = (restore(args.restore_from, convert_checkpoint, device)
              if args.restore_from else None)
    return GauGANRunner(model_cfg, run_cfg, params=params, seed=args.seed,
                        module=module, device=device)


def synthetic_items(args):
    """``sige_tpu``'s synthetic edit: labels uniform over the classes but
    the last, and a square of ~1.2% of the canvas set to the last class."""
    rng = np.random.default_rng(args.seed)
    H = round(args.crop_size / args.aspect_ratio)
    l0 = rng.integers(0, args.input_nc - 1, (H, args.crop_size))
    l1 = l0.copy()
    side = max(4, int(round((0.012 * H * args.crop_size) ** 0.5)))
    l1[H // 3 : H // 3 + side,
       args.crop_size // 3 : args.crop_size // 3 + side] = args.input_nc - 1
    return [{"name": "synthetic", "original_label": l0,
             "original_instance": l0, "edited_label": l1,
             "edited_instance": l1}]


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    runner."""
    args = get_args(argv)
    runner = build_runner(args)
    if args.save_converted:
        from ..utils.checkpoint import save_params

        print("saved native checkpoint:",
              save_params(args.save_converted, runner.module.state_dict()))

    if args.synthetic:
        items = synthetic_items(args)
    else:
        from ..data import CityscapesEditDataset

        items = list(CityscapesEditDataset(
            args.data_root, symmetric=not args.no_symmetric_editing,
            image_ids=args.image_ids))

    with trace(args.trace, runner.device):
        _run_items(args, runner, items, not args.netG.startswith("sige"))
    return runner


def _run_items(args, runner, items, dense):
    rows = []
    for item in items:
        s0 = runner.preprocess_input(item["original_label"],
                                     item["original_instance"])
        s1 = runner.preprocess_input(item["edited_label"],
                                     item["edited_instance"])
        if args.mode == "profile":
            stats = profile(runner, s0, s1, args.warmup_times,
                            args.test_times,
                            mode="dense" if dense else "sparse")
            print(profile_line(item["name"], stats))
            continue
        if dense:
            # no gather to plan: the dense generator's own forward
            # (sige_tpu's runner.generate refuses an empty plan here)
            _, x1, _ = runner.preprocess(s0, s1)
            out = runner.model.dense(x1)[0].cpu().numpy()
        else:
            out = runner.generate(s0, s1)
        print(f"Image {item['name']}: Edit Ratio "
              f"{100 * runner.last_edit_ratio:.2f}%    Tiles "
              f"{tiles(runner.model)}")
        if args.save_dir:
            from ..data import save_image

            path = os.path.join(args.save_dir, f"{item['name']}.png")
            save_image(path, (out + 1.0) / 2.0)
            rows.append({"name": item["name"], "generated": path})
            print(f"saved {path}")
    if args.save_dir and rows:
        from ..utils.html import write_gallery

        write_gallery(os.path.join(args.save_dir, "index.html"), rows)


if __name__ == "__main__":
    main()
