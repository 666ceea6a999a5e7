"""Weight bridge: ``sige_tpu``'s flax parameter tree -> the port's
``state_dict``.

It takes the tree as nested dicts of **numpy arrays** (the caller does the
``jax.device_get``) and imports nothing of JAX. Names map segment by
segment: flax's list-module names ``down_blocks_0_1`` become torch's
``down_blocks.0.1``; leaves map as

  * conv ``kernel`` HWIO -> ``weight`` OIHW (``F.conv2d``'s layout);
  * ``Dense`` ``kernel`` [in, out] -> ``Linear`` ``weight`` [out, in];
  * norm ``scale`` (GroupNorm and the SD transformers' LayerNorm) ->
    ``weight``; ``bias`` -> ``bias``; a ``Dense`` without bias (the SD
    attention projections) has no ``bias`` on either side;
  * top-level parameters (``norm_out_scale`` / ``out_norm_scale`` and
    their biases) keep their names.

It serves the DDPM U-Net and the SD U-Net, encoder and decoder alike:
their trees hold no other kind of leaf.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

_LIST_NAME = re.compile(r"^(.*?)((?:_\d+)+)$")


def torch_path(flax_path: Sequence[str]) -> Tuple[str, ...]:
    """Module path segments of the port for a flax module path:
    ``("down_blocks_0_1", "main_gather")`` -> ``("down_blocks", "0", "1",
    "main_gather")``."""
    out = []
    for seg in flax_path:
        m = _LIST_NAME.match(seg)
        if m:
            out.append(m.group(1))
            out.extend(m.group(2)[1:].split("_"))
        else:
            out.append(seg)
    return tuple(out)


def _leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:    # HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:    # [in, out] -> [out, in]
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    if name == "scale":
        return "weight", value
    return name, value


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict for a ``sige_tpu`` parameter tree of numpy
    arrays (nested dicts keyed like flax's ``params`` collection)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: Tuple[str, ...]):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.asarray(v)
            if path:
                name, a = _leaf(k, a)
            else:
                name = k
            key = ".".join(torch_path(path) + (name,))
            out[key] = torch.from_numpy(np.array(a, np.float32))

    walk(params, ())
    return out
