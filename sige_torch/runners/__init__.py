"""Runners: preprocess -> generate / profile."""

from .diffusion_runner import (DiffusionRunConfig, DiffusionRunner,
                               data_transform, inverse_data_transform)

__all__ = ["DiffusionRunConfig", "DiffusionRunner", "data_transform",
           "inverse_data_transform"]
