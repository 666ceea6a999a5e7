"""Stable Diffusion suite CLI (reference: stable-diffusion/run.py) — the
port of ``sige_tpu.cli.sd``.

  python -m sige_torch.cli.sd --task sdedit --init_img a.png --edited_img b.png \
      --embeddings emb.npz --restore_from sd-v1-4.ckpt
  python -m sige_torch.cli.sd --task inpainting --init_img a.png --mask_path m.npy \
      --embeddings emb.npz
  HF_HUB_CACHE=/data/hub python -m sige_torch.cli.sd --task sdedit --synthetic \
      --prompt "a church at dusk" --safety_model /data/safety-checker

Text conditioning comes from ``--embeddings`` (an .npz with ``uc`` and
``c``, [1, 77, 768]) or from ``--prompt``: ``encode_prompts(["",
prompt])`` through the port's CLIP text encoder, from a local
``openai/clip-vit-large-patch14`` snapshot in the hub cache
(``HF_HUB_CACHE``, ``$HF_HOME/hub`` or ``~/.cache/huggingface/hub``;
nothing is downloaded). ``--safety_model`` screens the sample through a
local ``CompVis/stable-diffusion-safety-checker`` snapshot before the
watermark, as the reference screens every saved sample. It runs on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from .common import add_device_flag


def get_args(argv=None):
    p = argparse.ArgumentParser(description="SIGE-torch Stable Diffusion")
    p.add_argument("--task", choices=("inpainting", "sdedit"), required=True)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--init_img", type=str, default=None)
    p.add_argument("--edited_img", type=str, default=None)
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--strength", type=float, default=0.8)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--restore_from", type=str, default=None,
                   help="sd-v1-4-style checkpoint to convert, or a native "
                        "checkpoint dir written by --save_converted")
    p.add_argument("--save_converted", type=str, default=None,
                   help="write the (converted) weights as a native "
                        "checkpoint dir, which later runs load as they are")
    p.add_argument("--embeddings", type=str, default=None,
                   help=".npz with 'uc' and 'c' text embeddings "
                        "[1, 77, 768] (no CLIP weights ship here)")
    p.add_argument("--save_dir", type=str, default="results/sd")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--safety_model", type=str, default=None,
                   help="local CompVis/stable-diffusion-safety-checker "
                        "snapshot; flagged outputs are blacked out "
                        "(reference: stable-diffusion/utils.py:94-100)")
    p.add_argument("--no_watermark", action="store_true",
                   help="skip the invisible watermark (reference stamps "
                        "'StableDiffusionV1'; base_runner.py:63-65,93)")
    p.add_argument("--output_name", type=str, default=None,
                   help="output file name (default <task>.png)")
    p.add_argument("--hparams", type=str, default="",
                   help="dot-path config overrides prefixed unet./vae./"
                        "run. (e.g. 'unet.model_channels=8 vae.ch=8')")
    add_device_flag(p)
    return p.parse_args(argv)


def _apply_hparams(hparams: str, unet_cfg, vae_cfg, run_cfg):
    """``unet.x=v vae.y=v run.z=v`` overrides on the frozen dataclasses."""
    from ..utils.config import parse_value

    cfgs = {"unet": unet_cfg, "vae": vae_cfg, "run": run_cfg}
    for item in hparams.strip().split():
        if "=" not in item:
            continue
        key, value = item.split("=", 1)
        prefix, _, field = key.partition(".")
        if prefix not in cfgs or not field:
            raise SystemExit(f"--hparams key {key!r}: expected "
                             f"unet./vae./run. prefix")
        cur = getattr(cfgs[prefix], field)  # raises on unknown field
        val = parse_value(value, cur)
        if isinstance(cur, tuple) and isinstance(val, list):
            val = tuple(val)
        cfgs[prefix] = dataclasses.replace(cfgs[prefix], **{field: val})
    return cfgs["unet"], cfgs["vae"], cfgs["run"]


def synthetic_inputs(H: int, W: int, seed: int = 0):
    """``sige_tpu``'s synthetic sdedit / inpainting inputs: a random image
    in [-1, 1], the same with a 50 px square at (H/3, W/3) set to 0.5, and
    that square as the mask."""
    rng = np.random.default_rng(seed)
    init = rng.random((H, W, 3)).astype(np.float32) * 2 - 1
    edited = init.copy()
    edited[H // 3 : H // 3 + 50, W // 3 : W // 3 + 50] = 0.5
    mask = np.zeros((H, W), bool)
    mask[H // 3 : H // 3 + 50, W // 3 : W // 3 + 50] = True
    return init, edited, mask


def build_runner(args):
    """The :class:`SDRunner` for parsed flags, weights restored."""
    from ..models.sd import SDUNetConfig, SDVAEConfig
    from ..nn.engine import resolve_device
    from ..runners.sd_runner import SDRunConfig, SDRunner

    device = resolve_device(args.device)
    vae_cfg = SDVAEConfig(resolution=args.H)
    unet_cfg = SDUNetConfig()
    run_cfg = SDRunConfig(ddim_steps=args.ddim_steps,
                          guidance_scale=args.scale, strength=args.strength)
    if args.hparams:
        unet_cfg, vae_cfg, run_cfg = _apply_hparams(
            args.hparams, unet_cfg, vae_cfg, run_cfg)
    params = None
    if args.restore_from:
        from ..utils.checkpoint import restore
        from ..utils.convert_sd import convert_sd

        params = restore(args.restore_from, lambda sd: convert_sd(
            sd, channel_mult=unet_cfg.channel_mult,
            num_res_blocks=unet_cfg.num_res_blocks,
            attention_resolutions=unet_cfg.attention_resolutions,
            transformer_depth=unet_cfg.transformer_depth,
            vae_ch_mult=vae_cfg.ch_mult,
            vae_num_res_blocks=vae_cfg.num_res_blocks,
            vae_attn_resolutions=vae_cfg.attn_resolutions,
            resolution=vae_cfg.resolution), device)
    return SDRunner(unet_cfg, vae_cfg, run_cfg, params=params,
                    seed=args.seed, width=args.W, device=device)


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    runner."""
    args = get_args(argv)
    from ..data import load_image, save_image

    runner = build_runner(args)
    if args.save_converted:
        from ..utils.checkpoint import save_params

        tree = {"unet": runner.unet.module.state_dict(),
                "encoder": runner.encoder.module.state_dict(),
                "decoder": runner.decoder.module.state_dict(),
                "post_quant": runner.post_quant}
        print("saved native checkpoint:",
              save_params(args.save_converted, tree))

    uc = c = None
    if args.embeddings:
        z = np.load(args.embeddings)
        uc, c = z["uc"], z["c"]
    elif args.prompt:
        from ..models.sd.clip import encode_prompts

        emb = encode_prompts(["", args.prompt], device=runner.device)
        uc, c = emb[:1], emb[1:]

    if args.synthetic:
        init, edited, mask = synthetic_inputs(args.H, args.W, args.seed)
    else:
        init = load_image(args.init_img, size=(args.H, args.W)) * 2 - 1
        edited = (load_image(args.edited_img, size=(args.H, args.W)) * 2 - 1
                  if args.edited_img else None)
        mask = np.load(args.mask_path) if args.mask_path else None

    if args.task == "inpainting":
        if mask is None:
            raise SystemExit("inpainting needs --mask_path")
        out = runner.inpaint(init, mask, uc=uc, c=c, seed=args.seed)
    else:
        if edited is None:
            raise SystemExit("sdedit needs --edited_img")
        out = runner.sdedit(init, edited, uc=uc, c=c, seed=args.seed)

    # save path mirrors the reference: clamp -> safety check -> uint8 ->
    # invisible watermark -> write (base_runner.py:83-96)
    sample = np.clip((out + 1.0) / 2.0, 0.0, 1.0)
    if args.safety_model:
        from ..models.sd.safety import SafetyChecker

        checker = SafetyChecker.from_pretrained(args.safety_model,
                                                device=runner.device)
        checked, has_nsfw = checker(sample[None])
        sample = checked[0]
        if has_nsfw[0]:
            print("NSFW concept detected; output blacked out")
    else:
        # parity gap with the reference, which screens every saved sample
        # (base_runner.py:83-92): surfaced so the skip is visible
        print("WARNING: no --safety_model given; the NSFW safety check "
              "was SKIPPED (the reference always screens outputs)")
    if not args.no_watermark:
        from ..utils.watermark import WatermarkEncoder, put_watermark

        img8 = np.clip(np.round(sample * 255.0), 0, 255).astype(np.uint8)
        img8 = put_watermark(img8, WatermarkEncoder(b"StableDiffusionV1"))
        sample = img8.astype(np.float32) / 255.0
    path = os.path.join(args.save_dir,
                        args.output_name or f"{args.task}.png")
    save_image(path, sample)
    print(f"saved {path}")
    return runner


if __name__ == "__main__":
    main()
