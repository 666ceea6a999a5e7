"""Runners: the DDPM and Progressive Distillation SDEdit runners
(preprocess -> generate / profile), the Stable Diffusion runner
(sdedit / inpaint) and the GauGAN semantic-editing runner."""

from .diffusion_runner import (DiffusionRunConfig, DiffusionRunner,
                               data_transform, inverse_data_transform)
from .gaugan_runner import GauGANRunConfig, GauGANRunner
from .pd_runner import PDRunConfig, PDRunner
from .sd_runner import SDRunConfig, SDRunner

__all__ = ["DiffusionRunConfig", "DiffusionRunner", "data_transform",
           "inverse_data_transform", "GauGANRunConfig", "GauGANRunner",
           "PDRunConfig", "PDRunner",
           "SDRunConfig", "SDRunner"]
