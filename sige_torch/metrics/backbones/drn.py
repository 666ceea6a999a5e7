"""DRN-D-105 dilated ResNet + segmentation head for Cityscapes mIoU — the
port of ``sige_tpu.metrics.backbones.drn``.

The reference scores GauGAN edits with a DRN-D-105 DRNSeg at 19 classes
(reference: gaugan/metrics/drn.py:394-398, miou_score.py DRNSeg) loaded
from ``drn-d-105_ms_cityscapes.pth``. Arch: arch-"D" DRN with Bottleneck
blocks, layers [1,1,3,4,23,3,1,1], channels (16,32,64,128,256,512,512,
512); the head is a 1x1 conv to 19 classes + a frozen depthwise
bilinear-kernel 8x transposed-conv upsample (drn_seg fill_up_weights).
All BatchNorms run on their stored statistics (inference only). The
modules keep the reference's names (``base.<i>`` children, ``seg``), so
the state dict is the checkpoint's without the ``module.`` prefix, the
``up.weight`` (recomputed here) and ``num_batches_tracked``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import FrozenBN, nchw, place, run, seeded_state

LAYERS = (1, 1, 3, 4, 23, 3, 1, 1)
CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)


def _bn(c: int) -> FrozenBN:
    return FrozenBN(c, eps=1e-5)


class Bottleneck(nn.Module):
    """Reference: gaugan/metrics/drn.py:61-99 (the stride on conv2, the
    3x3 conv dilated by ``dilation`` with as much padding)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=d,
                               dilation=d, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = _bn(4 * planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, 4 * planes, 1, stride=stride, bias=False),
            _bn(4 * planes)) if downsample else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(h + res)


def _conv_layers(cin: int, cout: int, n: int, stride: int = 1,
                 dilation: int = 1) -> nn.Sequential:
    """conv3x3 + BN + ReLU runs (arch-"D" plain layers; reference:
    drn.py:197-215): the first conv strided, each dilated by
    ``dilation`` with as much padding."""
    mods = []
    for i in range(n):
        mods += [nn.Conv2d(cin if i == 0 else cout, cout, 3,
                           stride=stride if i == 0 else 1, padding=dilation,
                           dilation=dilation, bias=False),
                 _bn(cout), nn.ReLU()]
    return nn.Sequential(*mods)


def _bottlenecks(cin: int, planes: int, blocks: int, stride: int,
                 dilation: int) -> nn.Sequential:
    return nn.Sequential(*[
        Bottleneck(cin if i == 0 else 4 * planes, planes,
                   stride=stride if i == 0 else 1, dilation=dilation,
                   downsample=i == 0 and (stride != 1 or cin != 4 * planes))
        for i in range(blocks)])


def drn_d_105() -> nn.Sequential:
    """Feature trunk (through layer8), the reference's ``base``:
    [B, 3, H, W] -> [B, 512, H/8, W/8]. Reference:
    gaugan/metrics/drn.py:101-254 (arch "D", Bottleneck; layer3 and
    layer4 at stride 2, layer5 dilated 2, layer6 4, layer7 2)."""
    ch, ly = CHANNELS, LAYERS
    return nn.Sequential(
        nn.Sequential(nn.Conv2d(3, ch[0], 7, padding=3, bias=False),
                      _bn(ch[0]), nn.ReLU()),
        _conv_layers(ch[0], ch[0], ly[0]),
        _conv_layers(ch[0], ch[1], ly[1], stride=2),
        _bottlenecks(ch[1], ch[2], ly[2], 2, 1),
        _bottlenecks(4 * ch[2], ch[3], ly[3], 2, 1),
        _bottlenecks(4 * ch[3], ch[4], ly[4], 1, 2),
        _bottlenecks(4 * ch[4], ch[5], ly[5], 1, 4),
        _conv_layers(4 * ch[5], ch[6], ly[6], dilation=2),
        _conv_layers(ch[6], ch[7], ly[7], dilation=1),
    )


def _bilinear_up_kernel(k: int = 16) -> np.ndarray:
    """fill_up_weights kernel (reference: miou_score.py:120-128)."""
    f = int(np.ceil(k / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = np.arange(k)
    w1 = 1 - np.abs(i / f - c)
    return (w1[:, None] * w1[None, :]).astype(np.float32)


class DRNSeg(nn.Module):
    """DRN-D-105 trunk + 1x1 seg head + frozen 8x bilinear-kernel
    upsample; returns per-class logit maps at input resolution, NCHW."""

    def __init__(self, classes: int = 19):
        super().__init__()
        self.classes = classes
        self.base = drn_d_105()
        self.seg = nn.Conv2d(CHANNELS[-1], classes, 1)
        up = torch.from_numpy(_bilinear_up_kernel(16))
        self.register_buffer("up", up.expand(classes, 1, 16, 16).clone(),
                             persistent=False)

    def forward(self, x):
        logits = self.seg(self.base(x))
        # depthwise ConvTranspose2d(16, stride 8, pad 4): exactly 8h x 8w;
        # the kernel is symmetric, so no flip against sige_tpu's dilated
        # conv
        return F.conv_transpose2d(logits, self.up, stride=8, padding=4,
                                  groups=self.classes)


def convert_drn_seg(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``drn-d-105_ms_cityscapes.pth`` DRNSeg state dict ->
    :class:`DRNSeg`'s state dict: the ``module.`` prefix of
    ``nn.DataParallel`` stripped, the ``base.<i>`` numbering of the DRN's
    children [layer0, ..., layer8] kept, ``up.weight`` and
    ``num_batches_tracked`` dropped."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k == "up.weight" or k.endswith("num_batches_tracked"):
            continue
        out[k] = torch.as_tensor(np.asarray(v, np.float32))
    return out


class CityscapesSegmenter:
    """images [H, W, 3] in [0, 1] -> [H, W] trainId predictions. Without
    ``sd`` the segmenter is untrained (seeded; a pipeline dry run).
    ``device``: None means the GPU (raises without one)."""

    #: Cityscapes normalization used by the reference's SegList loader
    MEAN = np.array([0.29010095242892997, 0.32808144844279574,
                     0.28696394422942517], np.float32)
    STD = np.array([0.1829540508368939, 0.18656561047509476,
                    0.18447508988480435], np.float32)

    def __init__(self, sd: Optional[Mapping], classes: int = 19,
                 device=None):
        module = DRNSeg(classes=classes)
        state = (seeded_state(module) if sd is None
                 else convert_drn_seg(sd))
        self.module = place(module, state, device)

    def logits(self, img: np.ndarray) -> torch.Tensor:
        """[1, classes, H, W] logits of one image on the module's device."""
        x = (np.asarray(img, np.float32) - self.MEAN) / self.STD
        if x.ndim == 3:
            x = x[None]
        return run(self.module, nchw(x, self.module))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return self.logits(img).argmax(dim=1)[0].cpu().numpy()
