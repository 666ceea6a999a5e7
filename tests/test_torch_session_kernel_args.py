"""The session kernels' host logic, on the CPU: which instantiation a
launch takes (16-byte vectors or the scalar one) from the dtypes, C,
strides and pointer alignment, and the grid from the row count
(``sige_torch/ops/sessions.py vector_width``, ``crop_vector_width``,
``paste_vector_width``, ``row_chunks``). The kernels themselves run only on
the card (``tests/test_torch_gpu.py``); these functions decide what they
are given, and take any tensor, so CPU tensors stand in here.
"""

import pytest
import torch

from sige_torch.ops import sessions as ss


def _offset(t: torch.Tensor, elements: int) -> torch.Tensor:
    """A view of ``t``'s values, as contiguous, whose data pointer is
    ``elements`` elements past an aligned allocation."""
    flat = torch.empty(t.numel() + elements, dtype=t.dtype)
    view = flat[elements:].view(t.shape)
    view.copy_(t)
    return view


# (width, C, views as (pointer, element size, strides), flat pointers,
# expected)
RULE_CASES = [
    (4, 128, [(4096, 4, (48 * 48 * 128, 48 * 128, 128, 1))], [], 4),
    (8, 128, [(4096, 2, (256 * 128, 128, 128, 1))], [], 8),
    (4, 6, [(4096, 4, (60, 30, 6, 1))], [], 1),          # C not a multiple
    (4, 3, [(4096, 4, (30, 15, 3, 1))], [], 1),
    (4, 8, [(4096, 4, (160, 32, 16, 2))], [], 1),         # channel stride 2
    (4, 8, [(4100, 4, (160, 32, 8, 1))], [], 1),          # pointer off by 4 B
    (4, 8, [(4112, 4, (160, 32, 8, 1))], [], 4),          # 16 B past aligned
    (4, 8, [(4096, 4, (162, 32, 8, 1))], [], 1),          # batch stride
    (4, 8, [(4096, 4, (160, 34, 8, 1))], [], 1),          # row stride
    (4, 8, [(4096, 4, (320, 64, 16, 1))], [], 4),         # a channel slice
    (4, 8, [(4096, 2, (160, 32, 8, 1))], [], 4),          # bf16 base, 8 B
    (4, 8, [(4100, 2, (160, 32, 8, 1))], [], 1),          # bf16 base off 4 B
    (4, 8, [(4096, 4, (160, 32, 8, 1))], [8192, 8200], 1),  # param off 8 B
    (4, 8, [(4096, 4, (160, 32, 8, 1))], [8192, 8208], 4),
    (1, 8, [(4096, 4, (160, 32, 8, 1))], [], 1),
]


@pytest.mark.parametrize("width,C,views,flat,want", RULE_CASES)
def test_vector_width_rule(width, C, views, flat, want):
    assert ss.vector_width(width, C, views, flat) == want


@pytest.mark.parametrize("dtype,C,view,want", [
    (torch.float32, 128, "contiguous", 4),
    (torch.bfloat16, 128, "contiguous", 8),
    (torch.float32, 3, "contiguous", 1),
    (torch.float32, 6, "contiguous", 1),
    (torch.bfloat16, 6, "contiguous", 1),
    (torch.bfloat16, 8, "contiguous", 8),
    (torch.float32, 8, "channel_strided", 1),
    (torch.float32, 8, "offset", 1),
    (torch.bfloat16, 8, "offset", 1),
    (torch.float32, 8, "channel_slice", 4),
])
def test_crop_vector_width(dtype, C, view, want):
    """The crop's choice on tensors: 16 bytes of x's dtype, or 1 for a
    channel count or a view the vectors cannot cover."""
    x = torch.randn(4, 6, 7, C).to(dtype)
    if view == "channel_strided":
        x = torch.randn(4, 6, 7, 2 * C).to(dtype)[..., ::2]
    elif view == "offset":
        x = _offset(x, 1)
    elif view == "channel_slice":
        x = torch.randn(4, 6, 7, 3 * C).to(dtype)[..., C:2 * C]
    assert ss.crop_vector_width(x) == want


def test_crop_vector_width_reads_epilogue_params():
    """A [rows, C] param whose pointer is off 16-byte alignment sends the
    crop to the scalar instantiation; aligned ones keep the vectors."""
    x, scale = torch.randn(2, 6, 7, 8), torch.randn(2, 8)
    assert ss.crop_vector_width(x, (scale, None)) == 4
    assert ss.crop_vector_width(x, (None, _offset(scale, 2))) == 1


@pytest.mark.parametrize("base_dtype,win_dtype,base_view,want", [
    (torch.float32, torch.float32, "contiguous", 4),
    (torch.bfloat16, torch.float32, "contiguous", 4),
    (torch.bfloat16, torch.bfloat16, "contiguous", 8),
    (torch.bfloat16, torch.float32, "offset1", 1),   # 2 B off 8 B alignment
    (torch.bfloat16, torch.float32, "offset4", 4),   # 8 B off: still aligned
    (torch.bfloat16, torch.bfloat16, "offset4", 1),  # 8 B off 16 B alignment
    (torch.float32, torch.float32, "channel_strided", 1),
])
def test_paste_vector_width(base_dtype, win_dtype, base_view, want):
    """The paste's choice: 16 bytes of the window's dtype (a bf16 base
    under fp32 windows is read 8 bytes at a time), or 1."""
    C = 8
    base = torch.randn(2, 9, 10, C).to(base_dtype)
    if base_view == "offset1":
        base = _offset(base, 1)
    elif base_view == "offset4":
        base = _offset(base, 4)
    elif base_view == "channel_strided":
        base = torch.randn(2, 9, 10, 2 * C).to(base_dtype)[..., ::2]
    win = torch.randn(2, 4, 5, C).to(win_dtype)
    assert ss.paste_vector_width(base, win) == want
    assert ss.paste_vector_width(base, _offset(win, 1)) == 1


@pytest.mark.parametrize("rows,vectors,chunks", [
    (192, 1536, 3),       # a 4 x 48^2 x 128 fp32 window: 3 chunks a row
    (184, 1472, 3),       # 46^2 windows
    (48, 1536, 3),        # one 48^2 window: 512 vectors a chunk at least
    (768, 6144, 2),       # the tiles' 192^2 box crop at S = 4
    (1024, 8192, 2),      # a 4 x 256^2 x 128 paste
    (2048, 8192, 1),      # the same at S = 8: rows alone fill the grid
    (12, 20, 1),          # short rows: one chunk
    (1, 10 ** 6, ss.TARGET_BLOCKS),
    (10 ** 6, 3, 1),
])
def test_row_chunks(rows, vectors, chunks):
    assert ss.row_chunks(rows, vectors) == chunks


@pytest.mark.parametrize("rows", [1, 7, 48, 132, 500, ss.TARGET_BLOCKS,
                                  5000])
def test_row_chunks_fill_the_card(rows):
    """Over row lengths from one vector to 10^5: the grid reaches
    TARGET_BLOCKS unless the chunks would fall below THREADS * UNROLL
    vectors, and stays within grid.y."""
    for vectors in (1, 100, ss.THREADS, 1000, 6144, 10 ** 5):
        chunks = ss.row_chunks(rows, vectors)
        cap = -(-vectors // (ss.THREADS * ss.UNROLL))
        assert 1 <= chunks <= min(cap, 65535)
        assert rows * chunks >= ss.TARGET_BLOCKS or chunks == cap


def test_row_chunks_refuse_what_the_kernels_cannot_index():
    with pytest.raises(ValueError, match="session kernels"):
        ss.row_chunks(2 ** 31, 8)
    with pytest.raises(ValueError, match="session kernels"):
        ss.row_chunks(8, 2 ** 31)
