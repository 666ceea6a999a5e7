"""The Stable Diffusion v1 family: SDEdit at 512^2 with classifier-free
guidance, as ``SDRunner.sdedit`` runs it. Parts:

* ``unet``: two samples a session (unconditional and conditional text
  contexts, the same latent), the timestep drawn from the DDIM schedule's
  first ``strength`` share; an edit adds noise to the latent under the
  U-Net's mask at the latent's side;
* ``decoder``: one latent a session; an edit changes it as above, the
  decoder's masks dilated much further (``decoder_dilate``), as every SD
  edit ends with one sparse decode.

Configuration keys: ``model.unet`` (``SDUNetConfig`` fields),
``model.decoder`` (``SDVAEConfig`` fields), ``image`` (side), ``latent``
(side), ``context`` ([tokens, width]), ``sampling`` (``total_steps``,
``ddim_steps``, ``strength``), ``mask`` (``dilate``, ``min_res``,
``decoder_dilate``, ``decoder_min_res``), ``edit_noise``, ``bucket_min``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..masks import dilate_mask, downsample_mask
from ..reference import sd_decoder, sd_unet
from ..traffic import Traffic, timesteps
from . import Prepared, tuples

PARTS = ("unet", "decoder")

#: The CPU tests' cut: a few channels at a 256 px image, 32 px latent
#: (merged into a configuration's file, group by group).
TINY = {"model": {"unet": dict(model_channels=32, num_res_blocks=1,
                               attention_resolutions=[1, 2],
                               channel_mult=[1, 2], num_heads=4,
                               context_dim=16, num_groups=8),
                  "decoder": dict(ch=16, ch_mult=[1, 2], num_res_blocks=1,
                                  resolution=64, num_groups=8)},
        "image": 256, "latent": 32, "context": [7, 16],
        "mask": {"dilate": 2, "decoder_dilate": 4, "min_res": 4}}


def ddim_timesteps(sampling: Mapping):
    """The DDIM sequence's first ``strength`` share: 1, 1 + c, ... with c =
    total / ddim_steps (CompVis ``make_ddim_timesteps``, uniform)."""
    c = int(sampling["total_steps"]) // int(sampling["ddim_steps"])
    n = int(int(sampling["ddim_steps"]) * float(sampling["strength"]))
    return [1 + c * j for j in range(n)]


def prepare(config: Mapping, part: str, traffic: Traffic, seed: int,
            device) -> Prepared:
    if part not in PARTS:
        raise ValueError(f"the SD family has no part {part!r}")
    cfg = tuples(config["model"][part])
    S, pool = traffic.sessions, traffic.pool
    L, mk = int(config["latent"]), config["mask"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**62 + 1)
    latents = torch.randn((S, L, L, 4), generator=gen, device=device)
    noise = torch.randn((S, pool, L, L, 4), generator=gen, device=device)
    unet_masks = [[downsample_mask(dilate_mask(m, int(mk["dilate"])),
                                   min_res=int(mk["min_res"]))
                   for m in row] for row in traffic.masks]
    lmask = torch.from_numpy(np.stack([np.stack([p[(L, L)] for p in row])
                                       for row in unet_masks])).to(device)
    deltas = float(config["edit_noise"]) * noise * lmask[..., None]
    if part == "unet":
        B = 2
        ts = timesteps(ddim_timesteps(config["sampling"]), S, seed)
        t = torch.tensor(ts, dtype=torch.float32,
                         device=device)[:, None].expand(S, B).contiguous()
        tok, width = (int(v) for v in config["context"])
        ctx = torch.randn((S, B, tok, width), generator=gen, device=device)
        extras = (t, ctx)
        pyramids = unet_masks

        def reference(P, x, extras, run):
            return sd_unet.forward(P, cfg, x, *extras, run)

        def build():
            from sige_torch.models.sd import SDUNetConfig, SIGESDUNet
            with torch.device("meta"):
                module = SIGESDUNet(SDUNetConfig(**cfg))
            return module.to_empty(device=device)

        shapes = sd_unet.param_shapes(cfg)
    else:
        B = 1
        extras = ()
        pyramids = [[downsample_mask(
            dilate_mask(dilate_mask(m, int(mk["dilate"])),
                        int(mk["decoder_dilate"])),
            min_res=int(mk["decoder_min_res"]), dilation=0)
            for m in row] for row in traffic.masks]

        def reference(P, x, extras, run):
            return sd_decoder.forward(P, cfg, x, run)

        def build():
            from sige_torch.models.sd import SDVAEConfig, SIGEDecoder
            with torch.device("meta"):
                module = SIGEDecoder(SDVAEConfig(**cfg))
            return module.to_empty(device=device)

        shapes = sd_decoder.param_shapes(cfg)
    x0 = latents[:, None].expand(S, B, L, L, 4).contiguous()
    return Prepared(x0=x0, extras=extras,
                    deltas=[[deltas[i, e][None].expand(B, L, L, 4)
                             .contiguous() for e in range(pool)]
                            for i in range(S)],
                    pyramids=pyramids, build=build, shapes=shapes,
                    reference=reference, reference_cfg=cfg,
                    bucket_min=int(config["bucket_min"]))
