"""Stable Diffusion with SIGE wiring: the U-Net and the VAE."""

from .unet import (SDUNetConfig, SIGECrossAttention, SIGESDDownsample,
                   SIGESDResBlock, SIGESDUNet, SIGESDUpsample,
                   SIGESpatialTransformer, sd_timestep_embedding)
from .vae import (SDVAEConfig, SIGEDecoder, SIGEEncoder, SIGEVAEAttnBlock,
                  SIGEVAEDownsample, SIGEVAEResnetBlock, SIGEVAEUpsample)

__all__ = ["SDUNetConfig", "SIGESDUNet", "SIGESDResBlock",
           "SIGECrossAttention", "SIGESpatialTransformer",
           "SIGESDDownsample", "SIGESDUpsample", "sd_timestep_embedding",
           "SDVAEConfig", "SIGEEncoder", "SIGEDecoder", "SIGEVAEResnetBlock",
           "SIGEVAEAttnBlock", "SIGEVAEDownsample", "SIGEVAEUpsample"]
