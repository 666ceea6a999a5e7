"""Block geometry for tiling-based sparse convolution.

A Gather is always paired with a convolution. The gathered tile ("block")
must be a *legal* conv input: it covers ``n + 1`` conv output positions per
axis, so its size is ``n * stride + kernel`` and consecutive tiles start
``(n + 1) * stride`` apart in input coordinates (overlap = kernel - stride,
e.g. 2 for a 3x3 stride-1 conv with block 6).

Semantics match the reference engine (reference: sige/nn/gather.py:26-43):
  * requested block sizes are rounded down to the nearest legal size,
  * the index offset defaults to the conv padding so tile indices live in
    *padded* input coordinates and may be negative,
  * the scatter target tile origin in conv-output coordinates is
    ``(offset + idx) // stride`` (reference: sige/cpu/scatter.cpp:20-21),
  * the conv-output tile extent is ``R = (block - kernel) // stride + 1``
    (reference: sige/cpu/scatter_gather.cpp:157).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

IntPair = Tuple[int, int]


def _pair(v: Union[int, IntPair]) -> IntPair:
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """Static tile geometry for one Gather/Scatter pair.

    Hashable and fully static so it can parameterize jitted functions and
    serve as a planning-cache key.
    """

    block_size: IntPair      # gathered tile size in conv-input coords (bh, bw)
    block_stride: IntPair    # spacing between candidate tiles in input coords
    offset: IntPair          # index offset (defaults to conv padding)
    kernel_size: IntPair     # paired conv kernel
    conv_stride: IntPair     # paired conv stride

    @staticmethod
    def create(
        block_size: Union[int, IntPair],
        kernel_size: Union[int, IntPair],
        conv_stride: Union[int, IntPair] = 1,
        padding: Union[int, IntPair] = 0,
        offset: Union[int, IntPair, None] = None,
    ) -> "BlockGeometry":
        bs, ks, st = _pair(block_size), _pair(kernel_size), _pair(conv_stride)
        n0 = max(bs[0] - ks[0], 0) // st[0]
        n1 = max(bs[1] - ks[1], 0) // st[1]
        legal = (n0 * st[0] + ks[0], n1 * st[1] + ks[1])
        stride = ((n0 + 1) * st[0], (n1 + 1) * st[1])
        off = _pair(padding) if offset is None else _pair(offset)
        return BlockGeometry(
            block_size=legal,
            block_stride=stride,
            offset=off,
            kernel_size=ks,
            conv_stride=st,
        )

    @property
    def out_tile_size(self) -> IntPair:
        """Conv-output tile extent (R, S) produced from one gathered block."""
        return (
            (self.block_size[0] - self.kernel_size[0]) // self.conv_stride[0] + 1,
            (self.block_size[1] - self.kernel_size[1]) // self.conv_stride[1] + 1,
        )

    def out_tile_origin(self, idx_h: int, idx_w: int) -> IntPair:
        """Map an input-space tile index to its conv-output tile origin."""
        return (
            (self.offset[0] + idx_h) // self.conv_stride[0],
            (self.offset[1] + idx_w) // self.conv_stride[1],
        )
