"""Flash attention forward: the hand-written Hopper kernel, its plain
PyTorch twin, and the wrapper that picks between them by device.

The kernel (``sige_torch/csrc/flash_attn.cu``) replaces the Pallas TPU
kernel ``sige_tpu/ops/flash.py:_fwd_kernel`` (launched by
``flash_mha_bhsd``). It computes

    out = softmax(q . k^T * scale + bias[M]) . v

per (batch, head), online softmax with fp32 running max and sum, fp32
data. What bounds it on the H100 and how the design addresses that is in
the header of the CUDA source: at DDPM's single-head D = 512 shapes the
fp32 FMA rate bounds the work, and with one (batch, head) the grid
covers few SMs; the logits never leave shared memory, tiles are sized
for the 227 KB of shared memory per block, and ragged N and M are masked
in the kernel, so no shape gate or padding exists.

The shared library is compiled with ``nvcc`` for ``sm_90a`` into
``build/sige_torch/`` (beside the package) on first use and loaded with
ctypes. ``flash_mha`` on a CPU tensor runs :func:`flash_mha_plain`; on a
CUDA tensor it launches the kernel or raises. ``flash_mha.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attn.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sige_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_DIM = 512


class _Library:
    """The compiled kernel library, built and loaded on first use."""

    def __init__(self):
        self.fn = None
        self.path: Optional[Path] = None
        self.build_log = ""

    def _nvcc(self) -> str:
        for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
            if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
                return os.path.join(cand, "bin", "nvcc")
        found = shutil.which("nvcc")
        if found is None:
            raise RuntimeError("nvcc not found: the flash kernel builds with "
                               "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
        return found

    def build(self) -> Path:
        """Compile the source (skipped when a library built from the same
        source bytes exists) and return the library's path."""
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"libsige_flash_{digest[:12]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [self._nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{self.build_log}")
            os.replace(tmp, out)
        return out

    def load(self):
        if self.fn is None:
            self.path = self.build()
            lib = ctypes.CDLL(str(self.path))
            fn = lib.sige_flash_attn_f32
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_float] + [ctypes.c_int64] * 12
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self.fn = fn
        return self.fn


LIBRARY = _Library()


def flash_mha_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    scale: float, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: qh [B, N, H, D], kh/vh
    [B, M, H, D], bias optional [M] fp32 -> [B, N, H, D]."""
    s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, vh)


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
    if bias is not None and (bias.shape != (M,) or bias.dtype != torch.float32
                             or bias.device != qh.device):
        raise ValueError(f"bias must be fp32 [{M}] on {qh.device}")
    if N == 0 or M == 0 or B * H == 0:
        raise ValueError("empty attention")
    return B, N, H, D, M


def flash_mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              scale: float, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """qh [B, N, H, D], kh/vh [B, M, H, D], bias optional [M] fp32.
    Returns [B, N, H, D]. Runs the kernel on CUDA tensors and the plain
    version on CPU tensors."""
    if qh.device.type == "cpu":
        return flash_mha_plain(qh, kh, vh, scale, bias)
    if qh.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {qh.device}")
    B, N, H, D, M = _check(qh, kh, vh, bias)
    fn = LIBRARY.load()
    q, k, v = _kernel_ready(qh), _kernel_ready(kh), _kernel_ready(vh)
    b = None if bias is None else bias.contiguous()
    out = torch.empty((B, N, H, D), dtype=torch.float32, device=qh.device)
    with torch.cuda.device(qh.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if b is None else b.data_ptr(), out.data_ptr(),
                 B, H, N, M, D, float(scale),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
