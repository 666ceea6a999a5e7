"""EMA (exponential moving average) of a state dict — the port of
``sige_tpu.utils.ema``.

The reference keeps shadow params and copies them in at inference
(reference: diffusion/models/ema.py). Functional here, as in
``sige_tpu``: an EMA state is a state dict; :func:`ema_update` decays it
toward the live one (floating-point entries; others are copied)."""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def ema_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(shadow: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor],
               rate: float = 0.999) -> Dict[str, torch.Tensor]:
    """shadow = rate * shadow + (1 - rate) * params
    (reference: diffusion/models/ema.py update)."""
    return {k: (rate * s + (1.0 - rate) * params[k]
                if s.is_floating_point() else params[k].clone())
            for k, s in shadow.items()}
