"""Golden real-weights pipeline: download -> convert -> generate -> score
— the port of ``sige_tpu.cli.golden``.

One command that, given the reference's published checkpoints (local
file, local mirror, or the real URL once egress exists), reproduces the
reference's quality-measurement protocol end to end
(reference: diffusion/README.md "Quality Results" + get_metric.py;
gaugan/README.md "Quality Results"):

  python -m sige_torch.cli.golden --family ddpm \
      --data_root database/church_outdoor_sdedit --save_dir results/ddpm
  python -m sige_torch.cli.golden --family pd  --data_root ... --save_dir ...
  python -m sige_torch.cli.golden --family gaugan \
      --data_root database/cityscapes-edit --save_dir results/gaugan \
      -- --crop_size 512 --num_upsampling_layers more

Steps:
  1. fetch the checkpoint from the registry (md5-verified, resumable;
     ``--mirror`` points at any URL incl. the ``file://`` mirrors the
     dry-run tests use; SIGE_TPU_ALLOW_DOWNLOAD=1 permits fetching),
  2. run the family CLI in generate mode with the converted weights
     (cli/diffusion, cli/gaugan or cli/sd — conversion happens in their
     ``--restore_from`` path; extra args after ``--`` pass through),
  3. score PSNR/LPIPS/FID (diffusion, sd) or mIoU/FID (gaugan) against
     ``--gt_root`` (default ``<data_root>/gt``, the reference's layout)
     through cli/get_metric.

The family CLI and the metric backbones run on the GPU unless
``--device cpu`` is given (forwarded to both).

Published comparison points (measure, then compare): the reference paper
(SIGE, NeurIPS 2022) quality tables report parity between the SIGE
models and their originals on these exact protocols — PSNR vs gt and vs
the original model's outputs, LPIPS, FID for church256 DDPM/PD, and mIoU
for GauGAN on cityscapes-edit (reference: README.md "Quality",
diffusion/README.md:62-115, gaugan/README.md:63-127). The acceptance bar
is the reference's own: SIGE output quality within noise of the original
model at the published edit sizes.

The whole pipeline is dry-run tested with synthetic weights served over
a file:// mirror and a synthetic 2-image dataset
(tests/test_torch_golden.py), so the day the real .pth files land the
published-table comparison is this single invocation.
"""

from __future__ import annotations

import argparse
import os

from .common import add_device_flag

FAMILIES = {
    "ddpm": {
        "checkpoint": "church256-ddpm-fused_unet.pth",
        "cli_args": ["--config_path", "configs/church_ddim256-sige.yml"],
        "metrics": ("psnr", "lpips", "fid"),
    },
    "pd": {
        "checkpoint": "church128-pd-unet.pth",
        "cli_args": ["--config_path", "configs/church_pd128-sige.yml"],
        "metrics": ("psnr", "lpips", "fid"),
    },
    "gaugan": {
        "checkpoint": "fused_spade.pth",
        "cli_args": ["--netG", "sige_fused_spade"],
        "metrics": ("miou", "fid"),
    },
    # the reference's SD protocol: its three published examples
    # (reference: stable-diffusion/README.md:40-54 inpainting,
    # 121-151 img2img) run verbatim; each example's prompt embedding may
    # be precomputed at <data_root>/embeddings/<name>.npz (uc/c) for
    # environments without a local CLIP snapshot.
    "sd": {
        "checkpoint": "sd-v1-4.ckpt",
        "metrics": ("psnr", "lpips"),
        "examples": [
            {"name": "inpainting_0", "task": "inpainting",
             "prompt": "a photograph of a horse on a grassland",
             "init": "inpainting/original/0.png",
             "mask": "inpainting/masks/0.npy",
             "seed": "36", "W": "1024"},
            {"name": "img2img_0", "task": "sdedit",
             "prompt": "A fantasy landscape, trending on artstation",
             "init": "img2img/original/0.png",
             "edited": "img2img/edited/0.png", "seed": "11"},
            {"name": "img2img_1", "task": "sdedit",
             "prompt": "A fantasy beach landscape, trending on artstation",
             "init": "img2img/original/1.png",
             "edited": "img2img/edited/1.png", "seed": "95"},
        ],
    },
}


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="golden real-weights pipeline",
        epilog="extra args after -- pass through to the family CLI")
    p.add_argument("--family", required=True, choices=sorted(FAMILIES))
    p.add_argument("--data_root", required=True,
                   help="reference dataset layout (SDEdit pairs or "
                        "cityscapes-edit)")
    p.add_argument("--gt_root", default=None,
                   help="ground-truth dir (default <data_root>/gt)")
    p.add_argument("--mask_root", default=None,
                   help="optional .npy masks restricting PSNR/LPIPS/mIoU "
                        "to edited regions (<data_root>/masks in the "
                        "reference layout)")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--pretrained_root", default="pretrained")
    p.add_argument("--mirror", default=None,
                   help="override the registry URL (e.g. a file:// mirror)")
    p.add_argument("--checkpoint", default=None,
                   help="skip the registry: use this local checkpoint "
                        "directly (no md5 gate)")
    p.add_argument("--metrics", default=None,
                   help="comma list overriding the family's metric set")
    # metric backbone weights (local files; metrics whose weights are
    # missing are skipped with a warning, never fabricated)
    p.add_argument("--inception_weights", default=None)
    p.add_argument("--backbone_weights", default=None)
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--drn_weights", default=None)
    add_device_flag(p)
    args, passthrough = p.parse_known_args(argv)
    if passthrough and passthrough[0] == "--":
        passthrough = passthrough[1:]
    return args, passthrough


def _resolve_checkpoint(args) -> str:
    if args.checkpoint:
        return args.checkpoint
    from ..utils.registry import fetch

    name = FAMILIES[args.family]["checkpoint"]
    return fetch(name, root=args.pretrained_root, url=args.mirror)


def _generate(args, passthrough, ckpt) -> str:
    fam = FAMILIES[args.family]
    os.makedirs(args.save_dir, exist_ok=True)
    if args.family == "sd":
        from .sd import main as fam_main

        for ex in fam["examples"]:
            argv = ["--task", ex["task"], "--restore_from", ckpt,
                    "--save_dir", args.save_dir,
                    "--output_name", ex["name"] + ".png",
                    "--seed", ex["seed"],
                    "--init_img", os.path.join(args.data_root, ex["init"])]
            if "W" in ex:
                argv += ["--W", ex["W"]]
            if "mask" in ex:
                argv += ["--mask_path",
                         os.path.join(args.data_root, ex["mask"])]
            if "edited" in ex:
                argv += ["--edited_img",
                         os.path.join(args.data_root, ex["edited"])]
            emb = os.path.join(args.data_root, "embeddings",
                               ex["name"] + ".npz")
            if os.path.exists(emb):
                argv += ["--embeddings", emb]
            else:  # needs a local CLIP snapshot (models/sd/clip.py)
                argv += ["--prompt", ex["prompt"]]
            fam_main(argv + ["--device", args.device, *passthrough])
        return args.save_dir
    if args.family == "gaugan":
        from .gaugan import main as fam_main

        argv = [*fam["cli_args"], "--mode", "generate",
                "--restore_from", ckpt, "--data_root", args.data_root,
                "--save_dir", args.save_dir, "--device", args.device,
                *passthrough]
    else:
        from .diffusion import main as fam_main

        argv = [*fam["cli_args"], "--mode", "generate",
                "--restore_from", ckpt, "--data_root", args.data_root,
                "--save_dir", args.save_dir, "--device", args.device,
                *passthrough]
    fam_main(argv)
    return args.save_dir


def _score(args, result_dir) -> list:
    from .get_metric import main as metric_main

    wanted = (args.metrics.split(",") if args.metrics
              else FAMILIES[args.family]["metrics"])
    gt_root = args.gt_root or os.path.join(args.data_root, "gt")
    scored = []
    for metric in wanted:
        if metric == "fid" and not args.inception_weights:
            print("[golden] skipping fid: no --inception_weights (local "
                  "torchvision inception_v3 state dict required)")
            continue
        if metric == "lpips" and not (args.backbone_weights
                                      and args.lpips_weights):
            print("[golden] skipping lpips: needs --backbone_weights and "
                  "--lpips_weights")
            continue
        argv = ["--metric", metric, "--root", result_dir,
                "--gt_root", gt_root, "--device", args.device]
        if args.mask_root:
            argv += ["--mask_root", args.mask_root]
        if metric == "fid":
            argv += ["--inception_weights", args.inception_weights]
        if metric == "lpips":
            argv += ["--backbone_weights", args.backbone_weights,
                     "--lpips_weights", args.lpips_weights]
        if metric == "miou" and args.drn_weights:
            argv += ["--drn_weights", args.drn_weights]
        metric_main(argv)
        scored.append(metric)
    return scored


def main(argv=None) -> list:
    """Run the pipeline on ``argv`` (default: the command line); returns
    the metrics it scored."""
    args, passthrough = get_args(argv)
    ckpt = _resolve_checkpoint(args)
    print(f"[golden] checkpoint: {ckpt}")
    result_dir = _generate(args, passthrough, ckpt)
    scored = _score(args, result_dir)
    print(f"[golden] scored: {scored} — compare against the reference's "
          "published quality protocol (SIGE, NeurIPS 2022; "
          "reference diffusion/README.md:62-115, gaugan/README.md:63-127: "
          "SIGE matches the original model's PSNR/LPIPS/FID/mIoU at the "
          "published edit sizes)")
    return scored


if __name__ == "__main__":
    main()
