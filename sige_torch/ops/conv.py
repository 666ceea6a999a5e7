"""NHWC convolution helpers over ``F.conv2d``.

Activations are NHWC at every function boundary (the layout of
``sige_tpu``). Inside, the NHWC tensor is viewed as a channels_last NCHW
tensor, so ``F.conv2d`` runs on it with no copy and returns channels_last,
which views back as NHWC. Weights are stored in ``F.conv2d``'s own OIHW
layout (the weight bridge converts flax HWIO kernels).

Tile convs run with VALID padding — gathered blocks carry their own halo,
which is why the reference forces padding to zero in sparse mode
(reference: sige/nn/base.py:80-92).

Under a row band (rows of one map sharded over ranks,
``sige_torch.parallel.spatial``) a conv takes the rows its kernel reaches
beyond the band from the neighbouring ranks (:func:`band_halo`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..utils import trace

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


def band_halo(x: torch.Tensor, kh: int, stride: int, pads: IntPair,
              band) -> torch.Tensor:
    """This rank's band ``x`` [B, h, W, C] with the rows a conv of kernel
    height ``kh``, row stride ``stride`` and row padding ``pads`` = (top,
    bottom) reads beyond it: ``top`` rows from the rank above and ``kh -
    stride - top`` from the rank below, zeros beyond the canvas (its
    padding). The conv then runs with no row padding and gives this
    rank's band of its output, h / stride rows. ValueError where the
    bands do not line up: a band height not divisible by the stride (its
    first row would fall between output rows), or a conv whose output is
    not the input's height over its stride."""
    h = x.shape[1]
    H = band.height(h)
    top, bottom = pads
    if h % stride:
        raise ValueError(f"a band of {h} rows under a stride-{stride} conv: "
                         f"an odd band at this level (H={H} over "
                         f"{H // h} ranks)")
    if (H + top + bottom - kh) // stride + 1 != H // stride:
        raise ValueError(f"a {kh}-row conv with stride {stride} and row "
                         f"padding {pads} does not keep H={H} in bands")
    return band.halo(x, top, max(kh - stride - top, 0))


def conv2d_nhwc(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: Union[int, IntPair] = 1,
    padding=0,
    groups: int = 1,
    band=None,
) -> torch.Tensor:
    """Dense conv of NHWC ``x`` with OIHW ``w`` ([O, I / groups, kh, kw];
    ``groups`` is flax's ``feature_group_count``, C_in for a depthwise
    conv). ``padding`` is symmetric int(s), explicit ((top, bottom),
    (left, right)) pairs (asymmetric padding, e.g. DDPM's Downsample), or
    "VALID". ``band``: this rank's row band (``SIGECtx.band``) when the
    map's rows are sharded over ranks: ``x`` is the band, and so is the
    output (:func:`band_halo`). Returns NHWC. Inside the engine's
    ``fp32_scope`` a conv new to the process counts toward
    ``conv_new_shapes`` (:mod:`sige_torch.utils.trace`; channels last
    reads as a unit channel stride)."""
    (pt, pb), (pl, pr) = _pads(padding)
    if band is not None:
        kh, sh = w.shape[2], _pair(stride)[0]
        if kh > 1 or sh > 1 or pt or pb:
            x = band_halo(x, kh, sh, (pt, pb), band)
        pt = pb = 0
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad_arg = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad_arg = 0
    stride = _pair(stride)
    if trace.engine_scopes:
        trace.conv_key((xc.shape, xc.stride(1) == 1, w.shape, stride,
                         pad_arg, groups, x.dtype))
    out = F.conv2d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                   stride=stride, padding=pad_arg, groups=groups)
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
