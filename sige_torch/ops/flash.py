"""Flash attention forward: the hand-written Hopper kernels, their plain
PyTorch twins, and the wrapper that picks between them by device.

The kernels (``sige_torch/csrc/flash_attn.cu``) replace the Pallas TPU
kernel ``sige_tpu/ops/flash.py:_fwd_kernel`` (launched by
``flash_mha_bhsd``). Together they compute

    out = softmax(q . k^T * scale + bias[r(b), M]) . v

per (batch, head), online softmax with fp32 running max and sum, fp32
data. The key bias has R rows: one shared by every batch row, or one per
session of a batch stacked over R sessions, batch row b reading row
``r(b) = b // (B / R)`` (:func:`bias_rows`). The head dim picks the
attention kernel (:func:`tensor_core_head`): ``flash_fwd_f32_tc`` takes
both inner products on the tensor cores in split TF32 (3xTF32, fp32's
accuracy) for every D that is a multiple of 8 up to 256;
``flash_fwd_f32`` computes them on the SIMT units for the rest (D = 512).
Each walks the key range in tiles of :func:`block_k` keys staged with
``cp.async``; when the grid of query blocks (:func:`block_q` rows each) is
smaller than the card's SM count, :func:`_num_splits` cuts the key range
into ``splits`` runs of whole tiles (split-KV), each block writes an
unnormalised partial, and ``flash_combine_f32`` merges the partials. What
bounds the kernels on the H100 and how the design addresses that is in
the header of the CUDA source.

The shared library is compiled with ``nvcc`` for ``sm_90a`` into
``build/sige_torch/`` (beside the package) on first use and loaded with
ctypes (:class:`~sige_torch.ops.cuda_lib.CudaLibrary`). ``flash_mha`` on CPU tensors runs :func:`flash_mha_plain`; on
CUDA tensors it launches the kernels or raises. ``flash_mha.launches``
counts launches of an attention kernel (one per call),
``flash_mha.tc_launches`` those of the tensor-core kernel and
``flash_mha.combine_launches`` those of the combine kernel (one per call
whose key range is split).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from ..utils import trace
from .cuda_lib import CSRC, CudaLibrary

SOURCE = CSRC / "flash_attn.cu"
MAX_HEAD_DIM = 512

LIBRARY = CudaLibrary(SOURCE, "sige_flash", {"sige_flash_attn_f32": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float]
    + [ctypes.c_int64] * 12 + [ctypes.c_void_p], ctypes.c_int)})


def _add_bias(s: torch.Tensor, bias: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """Logits s [B, H, N, M] plus the key bias: [M] added to every row as
    it is; [R, M] with batch row b taking row b // (B / R)."""
    if bias is None:
        return s
    if bias.ndim == 1:
        return s + bias.to(s.dtype)
    rows = bias.to(s.dtype).repeat_interleave(s.shape[0] // bias.shape[0], 0)
    return s + rows[:, None, None, :]


def flash_mha_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    scale: float, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: qh [B, N, H, D], kh/vh
    [B, M, H, D], bias optional fp32 [M] or [R, M] (R dividing B: batch
    row b takes row b // (B / R)) -> [B, N, H, D]."""
    s = _add_bias(torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale, bias)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, vh)


def tensor_core_head(D: int) -> bool:
    """Whether head dim D takes the tensor-core kernel (``tc_head`` in the
    CUDA source): a multiple of 8 (whole k8 steps of the m16n8k8 product)
    up to 256 (its O accumulators in registers)."""
    return D % 8 == 0 and D <= 256


def block_q(D: int) -> int:
    """Query rows per block of the attention kernel that D takes (must
    match ``tc_block_q`` and ``kBQ`` in the CUDA source): four warps of
    two 16-row tiles at D <= 64, of one above; 16 on the SIMT kernel."""
    if not tensor_core_head(D):
        return 16
    return 128 if D <= 64 else 64


def block_k(D: int) -> int:
    """Keys per tile of the attention kernel that D takes (must match
    ``tc_block_k`` and ``kBK`` in the CUDA source): 16 on the tensor-core
    kernel above D = 160, where its split q, K and V take the shared
    memory, else 32."""
    return 16 if tensor_core_head(D) and D > 160 else 32


def _num_splits(G: int, N: int, M: int, D: int, sms: int) -> int:
    """How many key ranges the kernel splits M into: enough blocks to
    cover the SMs when the query blocks alone do not, never more ranges
    than key tiles (so none is empty), 1 when the grid fills the card."""
    blocks = -(-N // block_q(D)) * G
    if blocks >= sms:
        return 1
    return min(-(-M // block_k(D)), -(-sms // blocks))


def _split_bounds(M: int, D: int, splits: int):
    """[(first key, end key)] of each split: whole key tiles of head dim
    D's kernel, split s taking tiles [s*T//splits, (s+1)*T//splits) as
    the kernel does."""
    bk = block_k(D)
    tiles = -(-M // bk)
    if not 1 <= splits <= tiles:
        raise ValueError(f"splits must be in [1, {tiles}] for M = {M}, "
                         f"got {splits}")
    return [(s * tiles // splits * bk, min((s + 1) * tiles // splits * bk, M))
            for s in range(splits)]


def flash_combine_plain(o_part: torch.Tensor, m_part: torch.Tensor,
                        l_part: torch.Tensor) -> torch.Tensor:
    """Plain version of the combine kernel: o_part [S, B, H, N, D]
    unnormalised partial outputs, m_part / l_part [S, B, H, N] their row
    max and sum -> [B, N, H, D] =
    sum_s e^(m_s - m*) O_s / sum_s e^(m_s - m*) l_s, m* = max_s m_s."""
    w = torch.exp(m_part - m_part.amax(dim=0))
    out = (w[..., None] * o_part).sum(0) / (w * l_part).sum(0)[..., None]
    return out.permute(0, 2, 1, 3)


def flash_partials_plain(qh: torch.Tensor, kh: torch.Tensor,
                         vh: torch.Tensor, scale: float,
                         bias: Optional[torch.Tensor], splits: int):
    """Each split's unnormalised partial output, row max and row sum, in
    the layout the attention kernel writes them ([S, B, H, N, D] and
    [S, B, H, N])."""
    s = _add_bias(torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale, bias)
    o, m, l = [], [], []
    for kb, ke in _split_bounds(kh.shape[1], kh.shape[-1], splits):
        ss = s[..., kb:ke]
        mx = ss.amax(dim=-1)
        p = torch.exp(ss - mx[..., None])
        o.append(torch.einsum("bhnm,bmhd->bhnd", p, vh[:, kb:ke]))
        m.append(mx)
        l.append(p.sum(dim=-1))
    return torch.stack(o), torch.stack(m), torch.stack(l)


def flash_mha_plain_split(qh: torch.Tensor, kh: torch.Tensor,
                          vh: torch.Tensor, scale: float,
                          bias: Optional[torch.Tensor] = None,
                          splits: int = 1) -> torch.Tensor:
    """Plain version of the split path: partials per key range, then
    :func:`flash_combine_plain`. Equals :func:`flash_mha_plain`."""
    return flash_combine_plain(
        *flash_partials_plain(qh, kh, vh, scale, bias, splits))


def bias_rows(bias: torch.Tensor, M: int) -> int:
    """R of a key bias given as [M] (R = 1) or [R, M]; ValueError for any
    other shape."""
    if bias.shape == (M,):
        return 1
    if bias.ndim == 2 and bias.shape[1] == M and bias.shape[0] >= 1:
        return int(bias.shape[0])
    raise ValueError(f"bias must be [{M}] or [R, {M}], got "
                     f"{tuple(bias.shape)}")


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """Unit stride along D, 16-byte aligned rows (the kernel's float4
    loads); anything else is copied."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check(qh, kh, vh, bias) -> Tuple[int, int, int, int, int]:
    B, N, H, D = qh.shape
    M = kh.shape[1]
    if kh.shape != (B, M, H, D) or vh.shape != (B, M, H, D):
        raise ValueError(f"q {tuple(qh.shape)}, k {tuple(kh.shape)}, "
                         f"v {tuple(vh.shape)}: expected [B, N|M, H, D]")
    for name, t in (("q", qh), ("k", kh), ("v", vh)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash kernel takes fp32 {name}, got {t.dtype}")
        if t.device != qh.device:
            raise ValueError(f"{name} on {t.device}, q on {qh.device}")
    if D % 4 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dims that are multiples "
                         f"of 4 up to {MAX_HEAD_DIM}, got {D}")
    if bias is not None:
        R = bias_rows(bias, M)
        if (B % R or bias.dtype != torch.float32 or bias.device != qh.device
                or not bias.is_contiguous()):
            raise ValueError(f"bias must be contiguous fp32 [{M}] or [R, {M}] "
                             f"with R dividing {B}, on {qh.device}; got "
                             f"{bias.dtype} {tuple(bias.shape)} on "
                             f"{bias.device}")
    if N == 0 or M == 0 or B * H == 0:
        raise ValueError("empty attention")
    return B, N, H, D, M


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
            scale: float, bias: Optional[torch.Tensor],
            splits: Optional[int] = None) -> torch.Tensor:
    """Launch the kernels on CUDA tensors with ``splits`` key ranges
    (None: :func:`_num_splits`'s choice). With ``splits`` > 1 the
    attention kernel writes its partials into scratch allocated with the
    output, and the combine kernel merges them into the output."""
    index = qh.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(qh, kh, vh, scale, bias, splits)
    with trace.span("sige.kernel.flash"):
        B, N, H, D, M = _check(qh, kh, vh, bias)
        tiles = -(-M // block_k(D))
        if splits is None:
            splits = _num_splits(B * H, N, M, D, _sm_count(index))
        elif not 1 <= splits <= tiles:
            raise ValueError(f"splits must be in [1, {tiles}] for M = {M}, "
                             f"got {splits}")
        fn = LIBRARY.load().sige_flash_attn_f32
        q, k, v = _kernel_ready(qh), _kernel_ready(kh), _kernel_ready(vh)
        # one allocation: out [B, N, H, D], then with splits > 1 the partials
        # o_part [S, B, H, N, D], m_part and l_part [S, B, H, N]
        size = B * N * H * D
        extra = 0 if splits == 1 else splits * B * H * N * (D + 2)
        buf = torch.empty(size + extra, dtype=torch.float32, device=qh.device)
        out = buf[:size].view(B, N, H, D)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), buf.data_ptr(),
                 None if splits == 1 else buf.data_ptr() + 4 * size,
                 B, H, N, M, D, splits,
                 1 if bias is None else bias_rows(bias, M), float(scale),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
        flash_mha.launches += 1
        if tensor_core_head(D):
            flash_mha.tc_launches += 1
        if splits > 1:
            flash_mha.combine_launches += 1
        return out


def flash_mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              scale: float, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """qh [B, N, H, D], kh/vh [B, M, H, D], bias optional fp32 [M]
    (shared) or [R, M] (R dividing B; batch row b takes row b // (B / R):
    one row per session of a batch stacked over R sessions).
    Returns [B, N, H, D]. Runs the kernels on CUDA tensors (split-KV when
    the query blocks alone leave SMs idle) and the plain version on CPU
    tensors."""
    if qh.device.type == "cpu":
        return flash_mha_plain(qh, kh, vh, scale, bias)
    if qh.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {qh.device}")
    return _launch(qh, kh, vh, scale, bias)


flash_mha.launches = 0
flash_mha.tc_launches = 0
flash_mha.combine_launches = 0
