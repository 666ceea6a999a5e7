"""DDPM U-Net with SIGE sparse wiring."""

from .unet import (DDPMUNetConfig, SIGEAttnBlock, SIGEDownsample,
                   SIGEFusedUNet, SIGEResnetBlock, SIGEUpsample,
                   timestep_embedding)

__all__ = ["DDPMUNetConfig", "SIGEFusedUNet", "SIGEResnetBlock",
           "SIGEAttnBlock", "SIGEDownsample", "SIGEUpsample",
           "timestep_embedding"]
