"""DDPM U-Net with SIGE sparse wiring, and the vanilla (unfused) U-Net."""

from .unet import (DDPMUNetConfig, SIGEAttnBlock, SIGEDownsample,
                   SIGEFusedUNet, SIGEResnetBlock, SIGEUpsample,
                   timestep_embedding)
from .vanilla import VanillaDDPMUNet

__all__ = ["DDPMUNetConfig", "SIGEFusedUNet", "SIGEResnetBlock",
           "SIGEAttnBlock", "SIGEDownsample", "SIGEUpsample",
           "timestep_embedding", "VanillaDDPMUNet"]
