"""Tests that need the card: the hand-written CUDA kernels against their
plain PyTorch twins. They import nothing of JAX (the machine with the
card has none) and skip without a CUDA device. On that machine:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest``: the suite's conftest.py sets JAX up.)
"""

import pytest
import torch

from sige_torch.ops import flash


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D,with_bias", [
    (1, 256, 256, 1, 512, False),   # DDPM 16 px
    (1, 64, 64, 1, 512, False),     # DDPM 8 px mid block
    (2, 100, 77, 2, 80, True),      # ragged N and M, key bias
    (1, 130, 300, 3, 40, True),
])
def test_kernel_matches_plain_twin_on_card(B, N, M, H, D, with_bias):
    if not torch.cuda.is_available():
        pytest.skip("the flash kernel runs only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    bias = None
    if with_bias:
        bias = torch.where(torch.rand(M, generator=gen, device="cuda") < 0.3,
                           -1e9, 0.0)
    before = flash.flash_mha.launches
    got = flash.flash_mha(q, k, v, D ** -0.5, bias)
    torch.cuda.synchronize()
    assert flash.flash_mha.launches == before + 1
    want = flash.flash_mha_plain(q, k, v, D ** -0.5, bias)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D", [
    (1, 256, 256, 1, 512),   # DDPM 16 px: 8 tiles
    (1, 64, 300, 1, 512),    # ragged M: the last split's tile holds 12 keys
    (2, 100, 256, 2, 40),
    (1, 70, 77, 3, 40),      # 3 tiles, the last one of 13 keys
])
@pytest.mark.parametrize("which", ["one", "two", "max"])
@pytest.mark.parametrize("dead_split", [False, True])
def test_forced_splits_match_plain_twin_on_card(B, N, M, H, D, which,
                                                dead_split):
    """The attention kernel with S = 1, 2 or ceil(M/32) key ranges (the
    combine kernel merging S > 1), against the plain version; with
    ``dead_split`` every key of split 1 (of S = 2 or max) carries -1e9."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tiles = -(-M // flash.BLOCK_K)
    splits = {"one": 1, "two": 2, "max": tiles}[which]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    bias = None
    if dead_split:
        bias = torch.zeros(M, device="cuda")
        kb, ke = flash._split_bounds(M, max(splits, 2))[1]
        bias[kb:ke] = -1e9
    launches = flash.flash_mha.launches
    combines = flash.flash_mha.combine_launches
    got = flash._launch(q, k, v, D ** -0.5, bias, splits)
    torch.cuda.synchronize()
    assert flash.flash_mha.launches == launches + 1
    assert flash.flash_mha.combine_launches == combines + (splits > 1)
    want = flash.flash_mha_plain(q, k, v, D ** -0.5, bias)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 512])
def test_split_path_matches_plain_split_on_card(D):
    """The attention kernel's partials merged by the combine kernel,
    against the plain split path (partials per key range, then the plain
    combine) at the same split count."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, M, H, splits = 1, 48, 256, 2, 8
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    combines = flash.flash_mha.combine_launches
    got = flash._launch(q, k, v, D ** -0.5, None, splits)
    torch.cuda.synchronize()
    assert flash.flash_mha.combine_launches == combines + 1
    want = flash.flash_mha_plain_split(q, k, v, D ** -0.5, None, splits)
    assert (got - want).abs().max().item() <= 1e-4
