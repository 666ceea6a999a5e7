"""Execution ops for tiling-based sparse convolution, in PyTorch.

All ops take NHWC tensors, fixed-capacity padded index buffers and a
static :class:`~sige_torch.core.geometry.BlockGeometry`. Plan products
lead with the installed plan's S >= 1 sessions. The tile ops are
gather/where compositions and the window ops crops and pastes at each
session's origin (:mod:`sige_torch.ops.sessions`, a hand-written kernel
each on CUDA tensors); attention runs through the hand-written flash
kernel on CUDA tensors (:mod:`sige_torch.ops.flash`).
"""

from .attention import masked_mha, mha
from .conv import conv2d_nhwc, tile_conv2d
from .flash import flash_mha, flash_mha_plain
from .gather import apply_epilogue, gather_tiles
from .scatter import (
    calibrate_residual,
    materialize_tiles,
    scatter_gather_residual_tiles,
    scatter_gather_tiles,
    scatter_tiles,
    scatter_tiles_box,
    scatter_with_block_residual_box,
)
from .window import (
    window_chain_extend,
    window_chain_extend_up2,
    window_epilogue,
    window_gather,
    window_scatter,
    window_scatter_block_residual,
    window_scatter_gather,
    window_slice,
    window_state_materialize,
)

__all__ = [
    "mha",
    "masked_mha",
    "flash_mha",
    "flash_mha_plain",
    "conv2d_nhwc",
    "tile_conv2d",
    "gather_tiles",
    "apply_epilogue",
    "scatter_tiles",
    "scatter_tiles_box",
    "scatter_gather_tiles",
    "scatter_with_block_residual_box",
    "materialize_tiles",
    "scatter_gather_residual_tiles",
    "calibrate_residual",
    "window_gather",
    "window_epilogue",
    "window_scatter_gather",
    "window_scatter",
    "window_slice",
    "window_chain_extend",
    "window_chain_extend_up2",
    "window_state_materialize",
    "window_scatter_block_residual",
]
