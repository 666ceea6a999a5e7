"""The DDPM family: the church256 U-Net under SDEdit (Meng et al.), as the
demo serves it: each session's original image noised to its timestep,
an edit replacing the content of its squares, the same noise on both.

Configuration keys: ``model.unet`` (``DDPMUNetConfig`` fields),
``sampling`` (``total_steps``, ``beta_start``, ``beta_end``,
``noise_level``, ``sample_steps``: the timesteps 0, n/s, ..., below the
noise level), ``mask`` (``dilate``, ``min_res``), ``bucket_min``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..masks import dilate_mask, downsample_mask
from ..reference import ddpm_unet
from ..traffic import Traffic, timesteps
from . import Prepared, linear_alphas_cumprod, tuples

PARTS = ("unet",)

#: The CPU tests' cut: a few channels at a 32 px image (merged into a
#: configuration's file, group by group).
TINY = {"model": {"unet": dict(ch=16, ch_mult=[1, 2, 2], num_res_blocks=1,
                               attn_resolutions=[8], resolution=32,
                               num_groups=8,
                               sparse_resolution_threshold=16)},
        "image": 32, "mask": {"dilate": 2, "min_res": 4}}


def timestep_sequence(sampling: Mapping):
    step = int(sampling["noise_level"]) // int(sampling["sample_steps"])
    return list(range(0, int(sampling["noise_level"]), step))


def prepare(config: Mapping, part: str, traffic: Traffic, seed: int,
            device) -> Prepared:
    if part not in PARTS:
        raise ValueError(f"the DDPM family has no part {part!r}")
    cfg = tuples(config["model"][part])
    R, S, pool = int(cfg["resolution"]), traffic.sessions, traffic.pool
    smp, mk = config["sampling"], config["mask"]
    ab = linear_alphas_cumprod(int(smp["total_steps"]),
                               float(smp["beta_start"]),
                               float(smp["beta_end"]))
    ts = timesteps(timestep_sequence(smp), S, seed)
    a = torch.tensor([ab[t] ** 0.5 for t in ts], dtype=torch.float32,
                     device=device)[:, None, None, None]
    b = torch.tensor([(1 - ab[t]) ** 0.5 for t in ts], dtype=torch.float32,
                     device=device)[:, None, None, None]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**62 + 1)
    image = torch.rand((S, R, R, 3), generator=gen, device=device) * 2 - 1
    noise = torch.randn((S, R, R, 3), generator=gen, device=device)
    content = torch.rand((S, pool, R, R, 3), generator=gen,
                         device=device) * 2 - 1
    x0 = (a * image + b * noise)[:, None]
    masks = torch.from_numpy(np.stack(
        [np.stack(m) for m in traffic.masks])).to(device)[..., None]
    deltas = torch.where(masks, a[:, None] * (content - image[:, None]),
                         torch.zeros((), device=device))
    pyramids = [[downsample_mask(dilate_mask(m, int(mk["dilate"])),
                                 min_res=int(mk["min_res"]))
                 for m in row] for row in traffic.masks]
    t = torch.tensor(ts, dtype=torch.float32, device=device)[:, None]

    def build():
        from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
        with torch.device("meta"):
            module = SIGEFusedUNet(DDPMUNetConfig(**cfg))
        return module.to_empty(device=device)

    def reference(P, x, extras, run):
        return ddpm_unet.forward(P, cfg, x, extras[0], run)

    return Prepared(x0=x0, extras=(t,),
                    deltas=[[deltas[i, e][None] for e in range(pool)]
                            for i in range(S)],
                    pyramids=pyramids, build=build,
                    shapes=ddpm_unet.param_shapes(cfg), reference=reference,
                    reference_cfg=cfg, bucket_min=int(config["bucket_min"]))
