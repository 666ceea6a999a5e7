"""NHWC convolution helpers over ``F.conv2d``.

Activations are NHWC at every function boundary (the layout of
``sige_tpu``). Inside, the NHWC tensor is viewed as a channels_last NCHW
tensor, so ``F.conv2d`` runs on it with no copy and returns channels_last,
which views back as NHWC. Weights are stored in ``F.conv2d``'s own OIHW
layout (the weight bridge converts flax HWIO kernels).

Tile convs run with VALID padding — gathered blocks carry their own halo,
which is why the reference forces padding to zero in sparse mode
(reference: sige/nn/base.py:80-92).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntPair = Tuple[int, int]


def _pair(v) -> IntPair:
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


def _pads(padding) -> Tuple[IntPair, IntPair]:
    """((top, bottom), (left, right)) from an int, an (h, w) pair, explicit
    pairs, or "VALID"."""
    if isinstance(padding, str):
        if padding != "VALID":
            raise ValueError(f"unsupported padding {padding!r}")
        return ((0, 0), (0, 0))
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if len(padding) == 2 and isinstance(padding[0], (tuple, list)):
        return tuple((int(p[0]), int(p[1])) for p in padding)
    ph, pw = _pair(padding)
    return ((ph, ph), (pw, pw))


def conv2d_nhwc(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: Union[int, IntPair] = 1,
    padding=0,
    groups: int = 1,
) -> torch.Tensor:
    """Dense conv of NHWC ``x`` with OIHW ``w`` ([O, I / groups, kh, kw];
    ``groups`` is flax's ``feature_group_count``, C_in for a depthwise
    conv). ``padding`` is symmetric int(s), explicit ((top, bottom),
    (left, right)) pairs (asymmetric padding, e.g. DDPM's Downsample), or
    "VALID". Returns NHWC."""
    (pt, pb), (pl, pr) = _pads(padding)
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad_arg = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad_arg = 0
    out = F.conv2d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                   stride=_pair(stride), padding=pad_arg, groups=groups)
    return out.permute(0, 2, 3, 1)


def tile_conv2d(
    tiles: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: Union[int, IntPair] = 1,
) -> torch.Tensor:
    """VALID conv over a gathered tile batch [B*K, bh, bw, C_in] ->
    [B*K, R, S, C_out]; the tile batch is the conv's batch axis."""
    return conv2d_nhwc(tiles, w, b, stride=stride, padding="VALID")
