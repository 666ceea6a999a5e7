"""The plain reference's building blocks: a SIGE sparse step written as a
dense forward with masks.

SIGE (Li et al., "Efficient Spatially Sparse Inference for Conditional
GANs and Diffusion Models", 2022) computes each sparse conv on the blocks
of its input that touch the edit mask and keeps the original image's
activations everywhere else. Written densely, every such layer is

    out = where(cov, layer(edited full map), layer(original full map))

where ``cov`` covers the conv-output tiles of the active blocks (the
rule of :func:`coverage`), and every GroupNorm of the sparse pass uses
the statistics of the original's pass. :class:`Pass` carries that: its
``orig`` pass records each scatter point's output and each norm's
statistics, its ``edit`` pass replays them under the edit's masks. Both
passes take NHWC maps and compute in NCHW with plain ``torch``
operations.

Nothing here imports the program: the mask pyramid, the block rule and
the weights come from the benchmark.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

IntPair = Tuple[int, int]


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and convs in IEEE fp32 (``tf32=False``) or in TF32,
    the caller's settings restored after."""
    cudnn, cuda = torch.backends.cudnn, torch.backends.cuda
    new_api = hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision")
    if new_api:
        saved = (cuda.matmul.fp32_precision, cudnn.conv.fp32_precision)
        mode = "tf32" if tf32 else "ieee"
        cuda.matmul.fp32_precision = cudnn.conv.fp32_precision = mode
    else:
        saved = (cuda.matmul.allow_tf32, cudnn.allow_tf32)
        cuda.matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        if new_api:
            cuda.matmul.fp32_precision, cudnn.conv.fp32_precision = saved
        else:
            cuda.matmul.allow_tf32, cudnn.allow_tf32 = saved


def block_geometry(block: int, kernel: int, stride: int, offset: int):
    """(legal block, block stride, output tile size, offset) of a SIGE
    gather paired with a ``kernel`` x ``kernel`` conv of ``stride``: the
    requested block rounded down to cover a whole number of outputs
    (reference: sige/nn/gather.py)."""
    n = max(block - kernel, 0) // stride
    return n * stride + kernel, (n + 1) * stride, n + 1, offset


def coverage(mask: torch.Tensor, block: int, kernel: int, stride: int,
             offset: int, out_hw: IntPair) -> torch.Tensor:
    """Bool [H', W'] of the conv outputs a sparse step recomputes: the
    output tiles of every block whose input window (``offset`` padding
    on the top and left) holds a masked pixel (reference:
    sige/utils.py reduce_mask)."""
    b, sb, R, off = block_geometry(block, kernel, stride, offset)
    H, W = mask.shape
    padded = torch.zeros((H + off + b, W + off + b), dtype=torch.float32,
                         device=mask.device)
    padded[off:off + H, off:off + W] = mask.to(torch.float32)
    pooled = F.max_pool2d(padded[None, None], b, sb)[0, 0] > 0
    cov = pooled.repeat_interleave(R, 0).repeat_interleave(R, 1)
    return cov[:out_hw[0], :out_hw[1]]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FlopCount:
    """Floating-point operations of a reference forward run under
    :func:`counting`: each conv, linear layer and attention adds twice
    its multiply-adds to ``by_region``, under the resolution of the
    :func:`sparse_region` it runs in (None outside any: a dense layer).
    An edit needs a sparse region's operations in the share of that
    resolution its mask covers."""

    def __init__(self):
        self.key = None
        self.by_region: Dict = {}


_COUNT: contextvars.ContextVar = contextvars.ContextVar("flops", default=None)


@contextlib.contextmanager
def counting(count: FlopCount):
    token = _COUNT.set(count)
    try:
        yield count
    finally:
        _COUNT.reset(token)


@contextlib.contextmanager
def sparse_region(hw: Optional[IntPair]):
    """Layers whose outputs a sparse step needs only under the mask at
    ``hw`` (None: every output, as a dense layer)."""
    count = _COUNT.get()
    if count is None or hw is None:
        yield
        return
    saved, count.key = count.key, tuple(hw)
    try:
        yield
    finally:
        count.key = saved


def _add(macs: float) -> None:
    count = _COUNT.get()
    if count is not None:
        count.by_region[count.key] = (count.by_region.get(count.key, 0.0)
                                      + 2.0 * macs)


def conv(P: Mapping, name: str, x: torch.Tensor, stride: int = 1,
         padding=1) -> torch.Tensor:
    """``name``'s conv (OIHW weight, bias) over NCHW ``x``; ``padding`` an
    int or (top, bottom, left, right)."""
    if isinstance(padding, tuple):
        x = F.pad(x, (padding[2], padding[3], padding[0], padding[1]))
        padding = 0
    w = P[name + ".weight"]
    out = F.conv2d(x, w, P.get(name + ".bias"), stride=stride,
                   padding=padding)
    _add(out.numel() * w[0].numel())
    return out


def linear(P: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    w = P[name + ".weight"]
    _add(x.numel() // x.shape[-1] * w.numel())
    return F.linear(x, w, P.get(name + ".bias"))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """Softmax attention of q [B, N, h*d] over k, v [B, M, h*d], heads
    outermost in the channels."""
    B, N, inner = q.shape
    d = inner // heads
    _add(2.0 * B * N * k.shape[1] * inner)
    qh = q.reshape(B, N, heads, d).transpose(1, 2)
    kh = k.reshape(B, -1, heads, d).transpose(1, 2)
    vh = v.reshape(B, -1, heads, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * d ** -0.5
    out = torch.matmul(torch.softmax(s, dim=-1), vh)
    return out.transpose(1, 2).reshape(B, N, inner)


def layer_norm(P: Mapping, name: str, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"],
                        P[name + ".bias"], eps)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def untokens(t: torch.Tensor, hw: IntPair) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], *hw)


class Pass:
    """One forward of the reference: ``mode`` "orig" (the original
    image's pass: records scatter outputs and norm statistics into
    ``store``) or "edit" (the sparse step: replays them under ``masks``,
    a {(h, w): bool [h, w]} pyramid on the compute device)."""

    def __init__(self, mode: str, store: Optional[Dict] = None,
                 masks: Optional[Mapping[IntPair, torch.Tensor]] = None,
                 windows: Optional[Mapping[IntPair, tuple]] = None):
        if mode not in ("orig", "edit"):
            raise ValueError(mode)
        self.mode = mode
        self.store = {} if store is None else store
        self.masks = masks
        self.windows = windows or {}
        self.out_reses = set()  # every scatter point's output resolution
        self._cov: Dict = {}

    def group_norm(self, name: str, x: torch.Tensor, weight, bias,
                   groups: int, eps: float = 1e-6,
                   live: bool = False) -> torch.Tensor:
        """GroupNorm of NCHW ``x``; in the edit pass with the original's
        statistics unless ``live``."""
        B, C, H, W = x.shape
        xg = x.reshape(B, groups, -1)
        if self.mode == "orig" or live:
            mean = xg.mean(dim=-1, keepdim=True)
            var = (xg - mean).square().mean(dim=-1, keepdim=True)
            if self.mode == "orig" and not live:
                self.store[name + "#stats"] = (mean, var)
        else:
            mean, var = self.store[name + "#stats"]
        xn = ((xg - mean) / torch.sqrt(var + eps)).reshape(B, C, H, W)
        return xn * weight[None, :, None, None] + bias[None, :, None, None]

    def cov(self, in_hw: IntPair, block: int, kernel: int, stride: int,
            offset: int, out_hw: IntPair) -> torch.Tensor:
        key = (in_hw, block, kernel, stride, offset, out_hw)
        if key not in self._cov:
            cov = coverage(self.masks[in_hw], block, kernel, stride, offset,
                           out_hw)
            if out_hw in self.windows:  # the window layout's window only
                r0, c0, wh, ww = self.windows[out_hw]
                rect = torch.zeros_like(cov)
                rect[r0:r0 + wh, c0:c0 + ww] = True
                cov = cov & rect
            self._cov[key] = cov
        return self._cov[key]

    def scatter(self, name: str, y: torch.Tensor, in_hw: IntPair,
                geom: Tuple[int, int, int, int]) -> torch.Tensor:
        """A scatter point: NCHW ``y`` where the sparse step recomputes it
        (``geom`` = block, kernel, stride, offset of its gather, whose
        input map is ``in_hw``), the original's output elsewhere."""
        if self.mode == "orig":
            self.out_reses.add(tuple(y.shape[2:]))
            self.store[name] = y
            return y
        cov = self.cov(in_hw, *geom, tuple(y.shape[2:]))
        return torch.where(cov[None, None], y, self.store[name])

    def block_residual(self, name: str, main: torch.Tensor,
                       short: torch.Tensor, in_hw: IntPair,
                       geom_main, geom_short) -> torch.Tensor:
        """The join of a resblock whose shortcut conv has a gather of its
        own: ``main + short`` in the original's pass; in the edit pass
        where(m, main + y1, y0) + where(s, short - y1, 0) with y0 the
        original's output and y1 its shortcut (the two masks' tiles
        differ)."""
        if self.mode == "orig":
            self.out_reses.add(tuple(main.shape[2:]))
            self.store[name] = main + short
            self.store[name + "#short"] = short
            return self.store[name]
        out_hw = tuple(main.shape[2:])
        m = self.cov(in_hw, *geom_main, out_hw)[None, None]
        s = self.cov(in_hw, *geom_short, out_hw)[None, None]
        y0, y1 = self.store[name], self.store[name + "#short"]
        return (torch.where(m, main + y1, y0)
                + torch.where(s, short - y1, torch.zeros_like(y1)))


def timestep_sincos(t: torch.Tensor, dim: int, cos_first: bool,
                    denom_offset: int) -> torch.Tensor:
    """Sinusoidal timestep embedding: frequencies exp(-ln(1e4) i / (half -
    ``denom_offset``)); [sin, cos] (DDPM) or [cos, sin] (SD)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - denom_offset))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    parts = [torch.cos(args), torch.sin(args)]
    if not cos_first:
        parts.reverse()
    emb = torch.cat(parts, dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def lecun_shapes_numel(shapes: Mapping[str, tuple]) -> int:
    """Elements of the weights drawn from the normal: every entry of two
    or more dimensions."""
    return sum(math.prod(s) for s in shapes.values() if len(s) >= 2)


def seeded_params(shapes: Mapping[str, tuple], seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """Seeded weights in one draw on ``device``: lecun-normal for every
    weight of two or more dimensions (conv OIHW and linear [out, in]:
    fan-in = numel / out), zero biases, unit 1-D scales. The same seed
    gives the same weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(lecun_shapes_numel(shapes), generator=gen,
                       device=device)
    out, at = {}, 0
    for name in sorted(shapes):
        shape = shapes[name]
        if len(shape) >= 2:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(
                (n // shape[0]) ** -0.5)
            at += n
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out
