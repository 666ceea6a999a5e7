"""Stable Diffusion runner: inpainting and SDEdit (img2img) with SIGE — the
port of ``sige_tpu.runners.sd_runner``.

Reference flows (reference: stable-diffusion/runners/inpainting_runner.py,
sdedit_runner.py, run.py):
  * inpainting: full-mode encode of the init image, the U-Net sparse per
    step with the latent blend ``q_sample(x0)*keep + img*edit``, the
    decoder primed by a full decode of the init latent, then a sparse
    decode of the samples;
  * sdedit (img2img): twin latents (init / edited) through the sparse
    encoder, DDIM stochastic encode at strength * steps, the
    twin-trajectory decode, the decoder masks re-dilated by 40 before the
    sparse decode.

Text conditioning is pluggable: pass precomputed (uc, c) embeddings
[B, seq, context_dim] (e.g. from any CLIP text encoder); no CLIP weights
ship with the repo.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.masks import compute_difference_mask, dilate_mask, downsample_mask
from ..models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder, SIGEEncoder,
                         SIGESDUNet)
from ..nn.engine import SIGEModel, fp32_scope, resolve_device
from ..samplers.sd_ddim import SDDDIMSampler


@dataclasses.dataclass(frozen=True)
class SDRunConfig:
    """The fields and defaults are ``sige_tpu``'s."""

    ddim_steps: int = 50
    guidance_scale: float = 7.5
    eta: float = 0.0
    scale_factor: float = 0.18215
    strength: float = 0.8          # img2img noise strength
    mask_eps: float = 2e-2
    mask_dilate_radius: int = 5
    decoder_dilate_radius: int = 40  # reference: sdedit_runner.py:100
    #: deepest U-Net mask-pyramid resolution (min dim): 8 is the SD
    #: U-Net's deepest latent level at 512 (64 / 2^3)
    mask_min_res: int = 8


class SDRunner:
    """The SD U-Net, encoder and decoder, each a :class:`SIGEModel` in the
    window layout (window-resident chains at the fine levels, masked
    stale-K/V transformers; the planner's ``max_cover`` sends the
    resolutions where the window would cover the canvas to tiles).

    ``params``: {"unet", "encoder", "decoder"} state dicts (e.g. from
    :func:`sige_torch.utils.from_jax.state_dict_from_flax`) and an
    optional "post_quant" (weight [z, z], bias [z]); without it the
    weights are drawn from ``seed``, ``seed + 1``, ``seed + 2``.
    ``device=None`` means the GPU and raises when there is none."""

    def __init__(self, unet_cfg: SDUNetConfig = SDUNetConfig(),
                 vae_cfg: SDVAEConfig = SDVAEConfig(),
                 run_cfg: SDRunConfig = SDRunConfig(),
                 params: Optional[Mapping] = None, seed: int = 0,
                 width: Optional[int] = None, device=None):
        self.unet_cfg, self.vae_cfg, self.run_cfg = unet_cfg, vae_cfg, run_cfg
        self.device = resolve_device(device)
        self.unet = SIGEModel(SIGESDUNet(unet_cfg), layout="window",
                              device=self.device)
        self.encoder = SIGEModel(SIGEEncoder(vae_cfg), layout="window",
                                 device=self.device)
        self.decoder = SIGEModel(SIGEDecoder(vae_cfg), layout="window",
                                 device=self.device)
        self.sampler = SDDDIMSampler(num_steps=run_cfg.ddim_steps,
                                     eta=run_cfg.eta,
                                     guidance_scale=run_cfg.guidance_scale)
        # rectangular canvases: ``width`` defaults to the square resolution
        R = vae_cfg.resolution
        self.width = width or R
        f = 2 ** (len(vae_cfg.ch_mult) - 1)
        self.latent_hw = (R // f, self.width // f)
        #: optional AutoencoderKL post_quant_conv as a pointwise latent map
        #: (weight [z, z], bias [z])
        self.post_quant = None
        models = {"unet": self.unet, "encoder": self.encoder,
                  "decoder": self.decoder}
        if params is not None:
            for name, model in models.items():
                model.module.load_state_dict(params[name])
            if params.get("post_quant") is not None:
                self.post_quant = tuple(map(self._tensor,
                                            params["post_quant"]))
        else:
            for i, model in enumerate(models.values()):
                model.init(seed + i)

    def _tensor(self, a) -> torch.Tensor:
        """fp32 on the runner's device, from numpy or torch."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def _image(self, img) -> torch.Tensor:
        return self._tensor(img).reshape(1, self.vae_cfg.resolution,
                                         self.width, -1)

    # ------------------------------------------------------------------
    def encode(self, img: torch.Tensor, mode: str = "full") -> torch.Tensor:
        """Image [1, R, W, 3] in [-1, 1] -> scaled latent mode (the
        posterior mean)."""
        fwd = self.encoder.full if mode == "full" else self.encoder.sparse
        return fwd(img)[..., :self.vae_cfg.z_channels] * \
            self.run_cfg.scale_factor

    @fp32_scope()
    def _pre_decode(self, z_scaled: torch.Tensor) -> torch.Tensor:
        """Unscale and apply post_quant_conv (reference:
        ldm/models/autoencoder.py:77-81), in fp32 like the models' own
        forwards."""
        z = z_scaled / self.run_cfg.scale_factor
        if self.post_quant is not None:
            w, b = self.post_quant
            z = torch.einsum("bhwc,pc->bhwp", z, w) + b
        return z

    def _default_contexts(self, uc, c):
        if c is None:
            c = torch.zeros((1, 77, self.unet_cfg.context_dim),
                            device=self.device)
        else:
            c = self._tensor(c)
        if uc is None:
            if self.run_cfg.guidance_scale != 1.0:
                uc = torch.zeros_like(c)
        else:
            uc = self._tensor(uc)
        return uc, c

    def _prime_unet(self, z, uc, c, masks) -> None:
        """One full pass (uncond and cond halves with guidance) records the
        U-Net's meta and fills its caches; then the plan."""
        n = 1 if uc is None else 2
        t0 = torch.zeros((z.shape[0] * n,), device=self.device)
        self.unet.full(torch.cat([z] * n), t0,
                       c if uc is None else torch.cat([uc, c]))
        self.unet.set_masks(masks)

    # ------------------------------------------------------------------
    def inpaint(self, init_img: np.ndarray, mask: np.ndarray, uc=None,
                c=None, seed: int = 0, noise: Optional[Sequence] = None
                ) -> np.ndarray:
        """Reference: inpainting_runner.py:27-77. ``mask`` is the edit
        region at image resolution; returns the image in [-1, 1]
        ([R, W, 3] numpy). Noise comes from a ``torch.Generator`` seeded
        with ``seed`` on the runner's device, or from ``noise``: x_T, then
        one latent per step."""
        rc = self.run_cfg
        init_latent = self.encode(self._image(init_img))
        uc, c = self._default_contexts(uc, c)
        masks = downsample_mask(np.asarray(mask, bool),
                                min_res=rc.mask_min_res, dilation=1)
        blend = 1.0 - self._tensor(masks[self.latent_hw])[None, :, :, None]

        gen = torch.Generator(device=self.device).manual_seed(seed)
        if noise is None:
            x_T = torch.randn(init_latent.shape, generator=gen,
                              device=self.device)
            steps = None
        else:
            x_T, *steps = map(self._tensor, noise)
        self._prime_unet(init_latent, uc, c, masks)
        samples = self.sampler.inpaint_sige(
            self.unet, x_T, init_latent, blend, uc, c,
            total_steps=rc.ddim_steps, generator=gen, noise=steps)

        # decode: prime with a full decode of the init latent, then decode
        # the samples sparsely
        self.decoder.full(self._pre_decode(init_latent))
        self.decoder.set_masks(masks)
        out = self.decoder.sparse(self._pre_decode(samples))
        return out[0].cpu().numpy()

    # ------------------------------------------------------------------
    def edit_masks(self, init_img, edited_img):
        """The mask pyramids of an SDEdit pair (images [R, W, 3] in
        [-1, 1]): the encoder's and U-Net's (the difference mask dilated
        by ``mask_dilate_radius``), and the decoder's (that mask
        re-dilated by ``decoder_dilate_radius`` at image resolution, its
        pyramid down to 4 without further dilation)."""
        rc = self.run_cfg
        x0, x1 = (self._image(a)[0].cpu().numpy()
                  for a in (init_img, edited_img))
        diff = dilate_mask(compute_difference_mask(x0, x1, eps=rc.mask_eps),
                           rc.mask_dilate_radius)
        masks = downsample_mask(diff, min_res=rc.mask_min_res, dilation=1)
        dec_mask = dilate_mask(diff, rc.decoder_dilate_radius)
        return masks, downsample_mask(dec_mask, min_res=(4, 4), dilation=0)

    def sdedit(self, init_img: np.ndarray, edited_img: np.ndarray, uc=None,
               c=None, seed: int = 0, noise=None) -> np.ndarray:
        """Reference: sdedit_runner.py + ddim.py:345-393. Images [R, W, 3]
        in [-1, 1]; returns the edited result in [-1, 1] ([R, W, 3]
        numpy). The stochastic-encode noise comes from a
        ``torch.Generator`` seeded with ``seed`` on the runner's device,
        or is ``noise`` (a latent)."""
        rc = self.run_cfg
        x0, x1 = self._image(init_img), self._image(edited_img)
        uc, c = self._default_contexts(uc, c)
        masks, dec_masks = self.edit_masks(init_img, edited_img)

        # sparse encode of the edited image over the init image's caches
        init_latent = self.encode(x0)
        self.encoder.set_masks(masks)
        edited_latent = self.encode(x1, mode="sparse")

        t_enc = int(rc.strength * rc.ddim_steps)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(edited_latent.shape, generator=gen,
                                device=self.device)
        else:
            noise = self._tensor(noise).reshape(edited_latent.shape)
        z_init = self.sampler.stochastic_encode(init_latent, t_enc - 1, noise)
        z_edit = self.sampler.stochastic_encode(edited_latent, t_enc - 1,
                                                noise)

        self._prime_unet(z_init, uc, c, masks)
        s_init, s_edit = self.sampler.img2img_decode_sige(
            self.unet, z_init, z_edit, uc, c, t_start=t_enc)

        self.decoder.full(self._pre_decode(s_init))
        self.decoder.set_masks(dec_masks)
        out = self.decoder.sparse(self._pre_decode(s_edit))
        return out[0].cpu().numpy()
