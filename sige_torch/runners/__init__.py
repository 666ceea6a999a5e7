"""Runners: the DDPM and Progressive Distillation SDEdit runners
(preprocess -> generate / profile) and the Stable Diffusion runner
(sdedit / inpaint)."""

from .diffusion_runner import (DiffusionRunConfig, DiffusionRunner,
                               data_transform, inverse_data_transform)
from .pd_runner import PDRunConfig, PDRunner
from .sd_runner import SDRunConfig, SDRunner

__all__ = ["DiffusionRunConfig", "DiffusionRunner", "data_transform",
           "inverse_data_transform", "PDRunConfig", "PDRunner",
           "SDRunConfig", "SDRunner"]
