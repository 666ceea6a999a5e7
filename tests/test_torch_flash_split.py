"""The split-KV path of the port's flash attention, on the CPU.

* ``flash_mha_plain_split`` (partials per key range, then the combine)
  against ``flash_mha_plain`` at atol 1e-6: the same fp32 arithmetic in
  another order (measured <= 7e-7 at these sizes with scale D**-0.5).
* ``flash_mha_plain_split`` against the Pallas kernel
  (``sige_tpu.ops.flash.flash_mha``) in TPU interpret mode, atol 1e-5 as
  in tests/test_torch_attention.py.
* ``_num_splits``, the wrapper's choice of splits, and
  ``_split_bounds``, the key range of each split, for both attention
  kernels (their query blocks and key tiles differ: ``block_q``,
  ``block_k``), at the shapes ``chip_smoke.py`` measures.

The kernels themselves run only on the card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.ops.flash import flash_mha as j_flash_mha
from sige_torch.ops import flash as tflash

H100_SMS = 132


def _qkv(rng, B, N, M, H, D):
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D)))


@pytest.mark.parametrize("M,splits", [
    (256, 1), (256, 2), (256, 3), (256, 8),
    (77, 1), (77, 2), (77, 3),            # ragged last split: keys 64..76
    (300, 1), (300, 2), (300, 3), (300, 8),
])
@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_split_equals_plain(rng, M, splits, with_bias):
    B, N, H, D = 2, 50, 2, 40
    q, k, v = _qkv(rng, B, N, M, H, D)
    bias = None
    if with_bias:
        bias = torch.from_numpy(
            np.where(rng.random(M) < 0.3, -1e9, 0.0).astype(np.float32))
    got = tflash.flash_mha_plain_split(q, k, v, D ** -0.5, bias, splits)
    want = tflash.flash_mha_plain(q, k, v, D ** -0.5, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("D", [40, 256, 512])
def test_split_whose_keys_are_all_masked_gets_no_weight(rng, D):
    B, N, M, H, splits = 1, 20, 256, 1, 8
    q, k, v = _qkv(rng, B, N, M, H, D)
    bias = torch.zeros(M)
    kb, ke = tflash._split_bounds(M, D, splits)[1]
    bias[kb:ke] = -1e9
    o_part, m_part, l_part = tflash.flash_partials_plain(
        q, k, v, D ** -0.5, bias, splits)
    # the dead split's partial is a full softmax of its own keys ...
    assert (l_part[1] >= 1.0).all()
    # ... and the combine weights it e^(-1e9 - m*) = 0
    got = tflash.flash_combine_plain(o_part, m_part, l_part)
    want = tflash.flash_mha_plain(q, k, v, D ** -0.5, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    alive = torch.ones(M, dtype=torch.bool)
    alive[kb:ke] = False
    drop = tflash.flash_mha_plain(q, k[:, alive], v[:, alive], D ** -0.5)
    np.testing.assert_allclose(got.numpy(), drop.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("N,M,H,D,splits,with_bias", [
    (128, 256, 1, 40, 3, False),
    (128, 256, 2, 40, 8, True),
    (256, 384, 1, 64, 5, True),
])
def test_plain_split_matches_pallas_kernel(rng, N, M, H, D, splits,
                                           with_bias):
    B = 1
    q, k, v = _qkv(rng, B, N, M, H, D)
    bias = None
    if with_bias:
        bias = np.where(rng.random(M) < 0.25, -1e9, 0.0).astype(np.float32)
    scale = D ** -0.5
    want = j_flash_mha(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                       jnp.asarray(v.numpy()), scale,
                       bias=None if bias is None else jnp.asarray(bias),
                       interpret=True)
    got = tflash.flash_mha_plain_split(
        q, k, v, scale, None if bias is None else torch.from_numpy(bias),
        splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("G,N,M,D,want", [
    (1, 256, 256, 512, 8),      # (a) DDPM 16 px: 16 blocks x 8 = 128
    (1, 64, 64, 512, 2),        # (b) DDPM 8 px mid block: 2 tiles
    (16, 4096, 4096, 40, 1),    # (c) SD 64x64 self-attention
    (16, 1024, 77, 80, 1),      # (d) SD text cross-attention
    # (e) SD masked stale/fresh: 8 blocks of 128 rows x 16 = 128 (it was
    # 1 with the SIMT kernel's 64-row blocks at D = 40)
    (16, 1024, 5120, 40, 2),
    # (z) K/V-cached sparse self 64^2: 2 blocks x 16 = 32, 5 splits (3
    # with the SIMT kernel's 64-row blocks)
    (16, 196, 4096, 40, 5),
    (80, 900, 4996, 64, 1),     # SDXL masked 64^2, S = 4
    (160, 324, 1348, 64, 1),    # SDXL masked 32^2, S = 4
    (64, 196, 452, 160, 1),     # SD masked 16^2, S = 4: 4 blocks x 64
    (1, 64, 300, 160, 10),      # one block: every 32-key tile its split
    (2, 100, 77, 256, 5),       # 2 blocks: 5 tiles of 16 keys
])
def test_num_splits_at_the_measured_shapes(G, N, M, D, want):
    assert tflash._num_splits(G, N, M, D, H100_SMS) == want


def test_num_splits_never_exceeds_the_tiles_and_fills_the_card(rng):
    for _ in range(300):
        G = int(rng.integers(1, 9))
        N, M = (int(x) for x in rng.integers(1, 2000, size=2))
        D = 4 * int(rng.integers(1, 129))
        s = tflash._num_splits(G, N, M, D, H100_SMS)
        tiles = -(-M // tflash.block_k(D))
        blocks = -(-N // tflash.block_q(D)) * G
        assert 1 <= s <= tiles
        assert blocks * s >= H100_SMS or s == tiles
        bounds = tflash._split_bounds(M, D, s)
        assert bounds[0][0] == 0 and bounds[-1][1] == M
        assert all(kb < ke for kb, ke in bounds)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(kb % tflash.block_k(D) == 0 for kb, _ in bounds)


@pytest.mark.parametrize("D,too_many", [(40, 4), (512, 4), (256, 6)])
def test_split_bounds_reject_more_splits_than_tiles(D, too_many):
    # M = 77: 3 tiles of 32 keys, 5 of 16 (the tensor-core kernel at D > 160)
    assert len(tflash._split_bounds(77, D, too_many - 1)) == too_many - 1
    with pytest.raises(ValueError):
        tflash._split_bounds(77, D, too_many)
    with pytest.raises(ValueError):
        tflash._split_bounds(77, D, 0)


def test_flash_mha_rejects_unsupported_devices():
    q = torch.zeros(1, 8, 1, 40, device="meta")
    with pytest.raises(ValueError):
        tflash.flash_mha(q, q, q, 40 ** -0.5)
