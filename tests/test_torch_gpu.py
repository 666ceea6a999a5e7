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
