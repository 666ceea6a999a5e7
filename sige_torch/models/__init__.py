"""Models of the port: the DDPM U-Net (``ddpm``), the Progressive
Distillation U-Net (``pd``) and Stable Diffusion's U-Net and VAE
(``sd``), on the blocks they share (``blocks``), and the GauGAN SPADE
generators (``gaugan``)."""

from . import ddpm, gaugan, pd, sd

__all__ = ["ddpm", "gaugan", "pd", "sd"]
