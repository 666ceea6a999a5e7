"""The tensor-core attention kernel's arithmetic, on the CPU.

* The dispatch rule: head dims that are multiples of 8 up to 256 take
  ``flash_fwd_f32_tc``, every other D the SIMT kernel.
* A numpy emulation of its split TF32 (3xTF32) products: every fp32
  operand x split into big = tf32(x) and small = tf32(x - big), rounded
  to nearest with ties away from zero at 10 mantissa bits as
  ``cvt.rna.tf32.f32`` rounds, each product small.big + big.small +
  big.big in fp32, walked over the key tiles with the kernel's online
  softmax. On small attention problems it stays within 1e-6 of fp64
  (fp32's own level), where one TF32 product per inner product reads
  above 1e-4: so the scheme, not luck, carries the kernel to fp32.

The kernel itself runs only on the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

from sige_torch.ops import flash


def tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (10 mantissa bits), ties away from zero; the low
    13 bits zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    big = tf32(x)
    return big, tf32(x - big)


def matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernel's three TF32 products, small terms first (each
    TF32 x TF32 product is exact in fp32)."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def matmul_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32(a) @ tf32(b)


def attention(q, k, v, scale, bias, matmul, bk):
    """softmax(q k^T scale + bias) v over key tiles of ``bk``, with the
    kernel's online softmax in the operands' dtype: running max from
    -1e30, rescale by exp(m - m_new), one division at the end."""
    dt = q.dtype.type
    N, D = q.shape
    m = np.full((N, 1), -1e30, q.dtype)
    l = np.zeros((N, 1), q.dtype)
    o = np.zeros((N, D), q.dtype)
    for k0 in range(0, k.shape[0], bk):
        s = matmul(q, k[k0:k0 + bk].T) * dt(scale) + bias[k0:k0 + bk]
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdims=True)
        o = o * alpha + matmul(p, v[k0:k0 + bk])
        m = m_new
    return o / l


@pytest.mark.parametrize("D,tc", [(8, True), (40, True), (64, True),
                                  (80, True), (160, True), (256, True),
                                  (4, False), (36, False), (260, False),
                                  (512, False)])
def test_tensor_core_kernel_takes_multiples_of_8_up_to_256(D, tc):
    assert flash.tensor_core_head(D) is tc
    # the SIMT kernel's block and tile; the tensor-core kernel's four warps
    # of 16-row tiles, two each at D <= 64, and 16-key tiles above 160
    want_q = (128 if D <= 64 else 64) if tc else 16
    want_k = 16 if tc and D > 160 else 32
    assert (flash.block_q(D), flash.block_k(D)) == (want_q, want_k)


def test_split_parts_are_tf32_and_sum_to_x(rng):
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(x - big) <= np.abs(x) * 2.0 ** -11).all()
    rest = np.abs(x.astype(np.float64) - big - small)
    assert (rest <= np.abs(x) * 2.0 ** -22).all()
    # ties round away from zero, as cvt.rna does
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], np.float32)
    np.testing.assert_array_equal(tf32(tie), [1.0 + 2.0 ** -10,
                                              -(1.0 + 2.0 ** -10)])


@pytest.mark.parametrize("D", [40, 64, 80, 160])
def test_split_tf32_attention_holds_fp32(rng, D):
    N, M = 50, 77  # ragged: the last key tile is partial
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((N, D), (M, D), (M, D)))
    bias = np.where(rng.random(M) < 0.3, -1e9, 0.0).astype(np.float32)
    scale, bk = D ** -0.5, flash.block_k(D)
    want = attention(*(t.astype(np.float64) for t in (q, k, v)), scale,
                     bias.astype(np.float64), np.matmul, M)
    den = np.abs(want).max()
    err3 = np.abs(attention(q, k, v, scale, bias, matmul_3xtf32, bk)
                  - want).max() / den
    err1 = np.abs(attention(q, k, v, scale, bias, matmul_tf32, bk)
                  - want).max() / den
    assert err3 <= 1e-6
    assert err1 > 1e-4
