"""Stable Diffusion with SIGE wiring: the U-Net and the VAE; the CLIP
text encoder with its tokenizer, and the safety checker."""

from .clip import FrozenCLIPEmbedder, encode_prompts
from .safety import SafetyChecker
from .tokenizer import CLIPTokenizer
from .unet import (SDUNetConfig, SIGECrossAttention, SIGESDDownsample,
                   SIGESDResBlock, SIGESDUNet, SIGESDUpsample,
                   SIGESpatialTransformer, sd_timestep_embedding)
from .vae import (SDVAEConfig, SIGEDecoder, SIGEEncoder, SIGEVAEAttnBlock,
                  SIGEVAEDownsample, SIGEVAEResnetBlock, SIGEVAEUpsample)

__all__ = ["SDUNetConfig", "SIGESDUNet", "SIGESDResBlock",
           "SIGECrossAttention", "SIGESpatialTransformer",
           "SIGESDDownsample", "SIGESDUpsample", "sd_timestep_embedding",
           "SDVAEConfig", "SIGEEncoder", "SIGEDecoder", "SIGEVAEResnetBlock",
           "SIGEVAEAttnBlock", "SIGEVAEDownsample", "SIGEVAEUpsample",
           "FrozenCLIPEmbedder", "encode_prompts", "CLIPTokenizer",
           "SafetyChecker"]
