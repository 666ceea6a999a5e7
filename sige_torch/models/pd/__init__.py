"""Progressive Distillation U-Net with SIGE sparse wiring."""

from .unet import PDUNetConfig, SIGEPDResnetBlock, SIGEPDUNet

__all__ = ["PDUNetConfig", "SIGEPDResnetBlock", "SIGEPDUNet"]
