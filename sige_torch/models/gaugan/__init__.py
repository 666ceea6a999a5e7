"""GauGAN (SPADE) model family — Cityscapes semantic-map editing: the
fused SPADE generator, the GAN-Compression sub-mobile one and the vanilla
dense baseline."""

from .spade import SIGEFusedSPADEGenerator, SPADEGenConfig
from .sub_mobile import SIGESubMobileSPADEGenerator, decode_config
from .vanilla import VanillaSPADEGenerator

__all__ = [
    "SPADEGenConfig",
    "SIGEFusedSPADEGenerator",
    "SIGESubMobileSPADEGenerator",
    "VanillaSPADEGenerator",
    "decode_config",
]
