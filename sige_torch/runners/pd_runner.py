"""Progressive Distillation runner: SDEdit with the PD few-step sampler —
the port of ``sige_tpu.runners.pd_runner``.

The same preprocess -> twin-trajectory flow as the DDPM runner
(:class:`~sige_torch.runners.diffusion_runner.DiffusionRunner`, whose
preprocess and profile it shares), with the logsnr schedule and the
6-channel (x0, eps) prediction (reference: diffusion/runner.py PD
branches + diffusion/samplers/pd_sampler.py; configs
church_pd{128,256}-*.yml).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..models.pd import PDUNetConfig, SIGEPDUNet
from ..samplers import PDSampler, get_sampling_sequence, logsnr_schedule
from .diffusion_runner import DiffusionRunner, inverse_data_transform


@dataclasses.dataclass(frozen=True)
class PDRunConfig:
    """Sampling config (reference: configs/church_pd256-sige.yml). The
    fields and defaults are ``sige_tpu``'s."""

    total_steps: int = 8
    sample_steps: int = 5
    noise_level: int = 5
    skip_type: str = "uniform"
    eps: float = 2e-2
    mask_dilate_radius: int = 2
    rescaled: bool = True


class PDRunner(DiffusionRunner):
    """Drives a SIGE PD U-Net through SDEdit generation and profiling.

    ``params`` is a state dict for the U-Net (e.g. from
    :func:`sige_torch.utils.from_jax.state_dict_from_flax`); without one
    the weights are drawn from ``seed``. ``device=None`` means the GPU and
    raises when there is none. ``layout="auto"`` (the default, as in
    ``sige_tpu``) picks the window or tile layout per edit."""

    def __init__(self, model_cfg: PDUNetConfig = PDUNetConfig(),
                 run_cfg: PDRunConfig = PDRunConfig(),
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, bucket_min: int = 2, layout: str = "auto",
                 device=None):
        self._build(SIGEPDUNet, model_cfg, run_cfg, params, seed, bucket_min,
                    layout, device)
        self.sampler = PDSampler(total_steps=run_cfg.total_steps)

    def _cond(self) -> torch.Tensor:
        """The logsnr at the noise level, [1] on the device."""
        rc = self.run_cfg
        return logsnr_schedule([rc.noise_level / rc.total_steps]).to(
            self.device)

    def generate(self, original: np.ndarray, edited: np.ndarray,
                 seed: int = 0) -> np.ndarray:
        """SDEdit: noise both images to ``noise_level``, denoise with the
        twin full/sparse trajectory, return the edited result in [0, 1]
        ([H, W, C] numpy). The noise comes from a ``torch.Generator``
        seeded with ``seed`` on the runner's device."""
        rc = self.run_cfg
        x0, x1, mask = self.preprocess(original, edited)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        e = torch.randn(x0.shape, generator=gen, device=self.device)
        seq = get_sampling_sequence(rc.sample_steps, rc.noise_level,
                                    rc.skip_type)
        xts = self.sampler.q_sample(torch.cat([x0, x1]), int(seq[-1]),
                                    torch.cat([e, e]))
        out = self.sampler.sample_sige(self.model, xts, seq,
                                       self._tensor(mask), x0, e)
        return inverse_data_transform(out[-1].cpu().numpy(), rc.rescaled)
