"""Models of the port: the DDPM U-Net (``ddpm``), the Progressive
Distillation U-Net (``pd``) and Stable Diffusion's U-Net and VAE
(``sd``), on the blocks they share (``blocks``)."""

from . import ddpm, pd, sd

__all__ = ["ddpm", "pd", "sd"]
