"""What the metric backbones share: inference BatchNorm on stored
statistics, seeded untrained weights, and one forward of an NHWC numpy
batch on the module's device inside the engine's fp32 scope."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.engine import fp32_scope


class FrozenBN(nn.Module):
    """BatchNorm on its stored statistics (inference only):
    ``(x - running_mean) / sqrt(running_var + eps) * weight + bias``. Its
    state dict holds what a torch ``BatchNorm2d`` checkpoint holds apart
    from ``num_batches_tracked``, which the converters drop."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


#: a bottleneck's last norm (``bn3``) is drawn this much smaller, as
#: training leaves a residual branch's last scale: with it drawn near 1,
#: every block doubles the trunk's variance and DRN-D-105's logits reach
#: ~1e8 (and a limit of 1e-4 * max|ref| with them); at 0.2 they stay ~1e1
BN3_SCALE = 0.2


def seeded_state(module: nn.Module, seed: int = 0):
    """Weights for ``module``'s state dict drawn from a CPU
    ``torch.Generator`` seeded with ``seed``, in key order: conv weights
    He-normal (std sqrt(2 / fan_in)), norm weights 1 + 0.1 N(0, 1)
    (times :data:`BN3_SCALE` for a bottleneck's ``bn3``), biases and
    running means 0.1 N(0, 1), running variances uniform in [0.5, 1.5].
    The untrained backbones (a pipeline dry run: the numbers mean
    nothing) and the synthetic checkpoints of the tests and of
    ``chip_smoke.py`` draw from it."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, v in module.state_dict().items():
        shape = tuple(v.shape)
        x = torch.randn(shape, generator=gen)
        if key.endswith("running_var"):
            x = 0.5 + torch.rand(shape, generator=gen)
        elif len(shape) >= 2:
            x *= math.sqrt(2.0 / math.prod(shape[1:]))
        elif key.endswith("weight"):
            x = 1.0 + 0.1 * x
            if key.endswith(".bn3.weight"):
                x *= BN3_SCALE
        else:
            x *= 0.1
        out[key] = x
    return out


def place(module: nn.Module, state, device) -> nn.Module:
    """``module`` with ``state`` loaded (``strict``), frozen, in eval mode,
    on ``device`` (None: the GPU, raising without one)."""
    from ...nn.engine import resolve_device

    module.load_state_dict(state, strict=True)
    module.requires_grad_(False)
    return module.eval().to(resolve_device(device))


def nchw(x: np.ndarray, module: nn.Module) -> torch.Tensor:
    """An NHWC numpy batch as an NCHW tensor on ``module``'s device and in
    its dtype."""
    p = next(module.parameters())
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(p.device, p.dtype).permute(0, 3, 1, 2)


def run(module: nn.Module, x: torch.Tensor):
    """``module(x)`` without autograd, in full fp32 (the engine's scope:
    no TF32 in cuDNN's convs; the caller's flags restored)."""
    with torch.inference_mode(), fp32_scope():
        return module(x)
