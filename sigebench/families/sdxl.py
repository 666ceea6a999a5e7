"""The Stable Diffusion XL family: SDXL's base U-Net at 1024² in SDEdit
with classifier-free guidance, stepped as SIGE's SDEdit steps SD v1's
(DDIM). One part, ``unet``: two samples a session (unconditional and
conditional), each with its own text context and label vector ``y``, the
same latent; an edit adds noise to the latent under the U-Net's mask at
the latent's side.

``y`` is SDXL's ``vector`` conditioning (generative-models
``sd_xl_base.yaml`` conditioner): the pooled text embedding, then the
cos-first sinusoidal embeddings (``Timestep``, ``size_embed`` wide) of
the original size (h, w), the crop's top-left corner and the target size
(h, w), in that order.

Configuration keys: ``model.unet`` (``SDUNetConfig`` fields), ``image``
(side), ``latent`` (side), ``context`` ([tokens, width]), ``pooled``
(width of the pooled text vector), ``size_embed`` (width of each size
number's embedding), ``sizes`` (``original``, ``crop``, ``target``: pairs),
``sampling`` (``total_steps``, ``ddim_steps``, ``strength``), ``mask``
(``dilate``, ``min_res``), ``edit_noise``, ``bucket_min``.

SD v1's U-Net traffic at 1024² gives every edit of every session the same
window extents, which the harness's replay refuses as first edits:
:func:`prepare` has the harness replay SDXL's sessions with
:class:`~sigebench.reference.pinned_windows.PinnedWindows`, which pins
them at once, as the program's stack does.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..masks import dilate_mask, downsample_mask
from ..reference import sdxl_unet
from ..reference.common import timestep_sincos
from ..reference.pinned_windows import PinnedWindows
from ..traffic import Traffic, timesteps
from . import Prepared, tuples
from .sd_v1 import ddim_timesteps

PARTS = ("unet",)

#: The CPU tests' cut: a few channels at a 256 px image, 32 px latent; a
#: depth of 2 at 16 px and 3 at 8 px and in the middle, 8-wide heads, a
#: 32-wide label vector (8 pooled + 6 sizes x 4) (merged into a
#: configuration's file, group by group).
TINY = {"model": {"unet": dict(model_channels=16, num_res_blocks=1,
                               transformer_depth=[1, 2, 3],
                               num_head_channels=8, context_dim=16,
                               adm_in_channels=32, num_groups=8)},
        "image": 256, "latent": 32, "context": [7, 16], "pooled": 8,
        "size_embed": 4, "mask": {"dilate": 2, "min_res": 4}}


def size_vector(config: Mapping, device) -> torch.Tensor:
    """The size conditioning [6 x size_embed]: each number of the
    original size, the crop's corner and the target size embedded."""
    sizes = config["sizes"]
    nums = [float(v) for key in ("original", "crop", "target")
            for v in sizes[key]]
    emb = timestep_sincos(torch.tensor(nums, device=device),
                          int(config["size_embed"]), cos_first=True,
                          denom_offset=0)
    return emb.reshape(-1)


def prepare(config: Mapping, part: str, traffic: Traffic, seed: int,
            device) -> Prepared:
    if part not in PARTS:
        raise ValueError(f"the SDXL family has no part {part!r}")
    cfg = tuples(config["model"][part])
    # a program without SDXL's fields refuses the configuration here,
    # before anything is drawn
    from sige_torch.models.sd import SDUNetConfig
    SDUNetConfig(**cfg)
    from .. import harness
    harness.SessionWindows = PinnedWindows
    pooled = int(config["pooled"])
    if pooled + 6 * int(config["size_embed"]) != int(cfg["adm_in_channels"]):
        raise ValueError("adm_in_channels is not pooled + 6 x size_embed")
    S, pool, B = traffic.sessions, traffic.pool, 2
    L, mk = int(config["latent"]), config["mask"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**62 + 1)
    latents = torch.randn((S, L, L, 4), generator=gen, device=device)
    noise = torch.randn((S, pool, L, L, 4), generator=gen, device=device)
    masks = [[downsample_mask(dilate_mask(m, int(mk["dilate"])),
                              min_res=int(mk["min_res"]))
              for m in row] for row in traffic.masks]
    lmask = torch.from_numpy(np.stack([np.stack([p[(L, L)] for p in row])
                                       for row in masks])).to(device)
    deltas = float(config["edit_noise"]) * noise * lmask[..., None]
    ts = timesteps(ddim_timesteps(config["sampling"]), S, seed)
    t = torch.tensor(ts, dtype=torch.float32,
                     device=device)[:, None].expand(S, B).contiguous()
    tok, width = (int(v) for v in config["context"])
    ctx = torch.randn((S, B, tok, width), generator=gen, device=device)
    text = torch.randn((S, B, pooled), generator=gen, device=device)
    sizes = size_vector(config, device).expand(S, B, -1)
    y = torch.cat([text, sizes], dim=-1).contiguous()

    def reference(P, x, extras, run):
        return sdxl_unet.forward(P, cfg, x, *extras, run)

    def build():
        from sige_torch.models.sd import SIGESDUNet
        with torch.device("meta"):
            module = SIGESDUNet(SDUNetConfig(**cfg))
        return module.to_empty(device=device)

    x0 = latents[:, None].expand(S, B, L, L, 4).contiguous()
    return Prepared(x0=x0, extras=(t, ctx, y),
                    deltas=[[deltas[i, e][None].expand(B, L, L, 4)
                             .contiguous() for e in range(pool)]
                            for i in range(S)],
                    pyramids=masks, build=build,
                    shapes=sdxl_unet.param_shapes(cfg), reference=reference,
                    reference_cfg=cfg, bucket_min=int(config["bucket_min"]))
