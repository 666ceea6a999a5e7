"""Runners: the DDPM SDEdit runner (preprocess -> generate / profile) and
the Stable Diffusion runner (sdedit / inpaint)."""

from .diffusion_runner import (DiffusionRunConfig, DiffusionRunner,
                               data_transform, inverse_data_transform)
from .sd_runner import SDRunConfig, SDRunner

__all__ = ["DiffusionRunConfig", "DiffusionRunner", "data_transform",
           "inverse_data_transform", "SDRunConfig", "SDRunner"]
