"""The port's attention against sige_tpu's.

* The plain twin of the flash kernel against the Pallas kernel
  (``sige_tpu.ops.flash.flash_mha``) run in TPU interpret mode on the CPU.
* ``mha`` / ``masked_mha`` on CPU tensors against sige_tpu's naive paths.

atol 1e-5: one softmax over fp32 logits computed by two einsum
implementations (and, for Pallas, an online softmax over KV blocks).

The kernel itself runs only on the card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.ops import attention as jattn
from sige_tpu.ops.flash import flash_mha as j_flash_mha
from sige_torch.ops import attention as tattn
from sige_torch.ops import flash as tflash

ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_twin_matches_pallas_kernel(rng, with_bias):
    B, N, M, H, D = 2, 128, 128, 1, 40  # G = B * H = 2
    q, k, v = _rand(rng, B, N, H, D), _rand(rng, B, M, H, D), \
        _rand(rng, B, M, H, D)
    bias = None
    if with_bias:
        bias = np.where(rng.random(M) < 0.25, -1e9, 0.0).astype(np.float32)
    scale = D ** -0.5
    want = j_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                       bias=None if bias is None else jnp.asarray(bias),
                       interpret=True)
    got = tflash.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), scale,
                           None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("N,M,heads,dim_head", [(64, 64, 1, 32),
                                                (50, 77, 2, 40)])
def test_mha_matches_naive(rng, N, M, heads, dim_head):
    B, inner = 2, heads * dim_head
    q, k, v = _rand(rng, B, N, inner), _rand(rng, B, M, inner), \
        _rand(rng, B, M, inner)
    want = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                     dim_head)
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), heads, dim_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_masked_mha_matches_naive(rng):
    B, N, Ms, Mf, heads, dim_head = 1, 48, 96, 32, 2, 40
    inner = heads * dim_head
    q = _rand(rng, B, N, inner)
    ks, vs = _rand(rng, B, Ms, inner), _rand(rng, B, Ms, inner)
    kf, vf = _rand(rng, B, Mf, inner), _rand(rng, B, Mf, inner)
    dead = np.zeros(Ms, bool)
    dead[rng.choice(Ms, Mf, replace=False)] = True
    bias_s = np.where(dead, -1e9, 0.0).astype(np.float32)
    bias_f = np.zeros(Mf, np.float32)
    want = jattn.masked_mha(*(jnp.asarray(a) for a in
                              (q, ks, vs, kf, vf, bias_s, bias_f)),
                            heads, dim_head)
    got = tattn.masked_mha(*(torch.from_numpy(a) for a in
                             (q, ks, vs, kf, vf, bias_s, bias_f)),
                           heads, dim_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 1, 40, dtype=torch.float64)
    with pytest.raises(TypeError):
        tflash._check(q, q, q, None)
    q = torch.zeros(1, 8, 1, 42)
    with pytest.raises(ValueError):
        tflash._check(q, q, q, None)
    q = torch.zeros(1, 8, 1, 1024)
    with pytest.raises(ValueError):
        tflash._check(q, q, q, None)
    with pytest.raises(ValueError):
        tflash.flash_mha(q.to("meta"), q.to("meta"), q.to("meta"), 1.0)
