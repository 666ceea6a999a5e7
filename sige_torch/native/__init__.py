"""ctypes bindings for the native host planner (``planner.cpp``): mask
dilation, active-tile reduction and the scatter source maps that
``SIGEModel.set_masks`` computes on the host for every edit.

The library is compiled with ``g++`` at first use into
``build/sige_torch/`` beside the package (ignored by git). Its file name
carries a digest of the source bytes, the compiler flags and the
machine, and it is compiled under a temporary name and renamed into
place, so processes that build at once each load a whole library and
never one another's partial file. Flags stay portable (no
``-march=native``): a library may be built on one host and loaded on
another of the same machine type.

:func:`available` says whether the library is in use; the core functions
(:mod:`sige_torch.core.masks`, :mod:`sige_torch.core.scatter_map`) call
it and else take their numpy paths, which give the same arrays bit for
bit. ``SIGE_TPU_NO_NATIVE=1`` (read on every call, as in ``sige_tpu``)
forces the numpy paths. Without ``g++`` on ``PATH`` the numpy paths run
and a warning says so once; a build that fails raises with the
compiler's log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
import uuid
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("planner.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sige_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class Planner:
    """The compiled planner library of ``source``, built into
    ``build_dir`` and loaded on the first :meth:`load`. ``build_s`` is
    the seconds this process spent compiling it (None when the library
    was already built), ``build_log`` the compiler's output."""

    def __init__(self, source=SOURCE, build_dir=BUILD_DIR):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_s: Optional[float] = None
        self.build_log = ""
        self._no_compiler = False

    def library_path(self) -> Path:
        """Where the library of this source, these flags and this machine
        lives."""
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(CXX_FLAGS).encode()
            + platform.machine().encode()).hexdigest()
        return self.build_dir / f"libsige_planner_{digest[:12]}.so"

    def build(self, compiler: str) -> Path:
        """Compile the source with ``compiler`` unless its library exists;
        return the library's path. Raises RuntimeError with the compiler's
        log when the build fails."""
        out = self.library_path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}."
                            f"{uuid.uuid4().hex[:8]}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [compiler, *CXX_FLAGS, str(self.source), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        self.build_s = time.perf_counter() - t0
        return out

    def load(self) -> Optional[ctypes.CDLL]:
        """The loaded library, built first if needed; None without
        ``g++`` on ``PATH`` (warned once)."""
        if self.lib is not None or self._no_compiler:
            return self.lib
        compiler = shutil.which("g++")
        if compiler is None:
            self._no_compiler = True
            warnings.warn("sige_torch.native: no g++ on PATH, the host "
                          "planner runs its numpy paths", RuntimeWarning,
                          stacklevel=2)
            return None
        self.path = self.build(compiler)
        lib = ctypes.CDLL(str(self.path))
        i64 = ctypes.c_int64
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.dilate_mask.argtypes = [u8p, u8p, i64, i64, i64, i64]
        lib.dilate_mask.restype = None
        lib.reduce_mask.argtypes = [u8p, i64, i64, i64, i64, i64, i64, i64,
                                    i64, i32p, i64, ctypes.c_int32]
        lib.reduce_mask.restype = i64
        lib.build_src_map.argtypes = [i32p, i64, i64, i64, i64, i64, i64,
                                      i64, i64, i64, i32p]
        lib.build_src_map.restype = None
        lib.build_sg_sources.argtypes = [i32p, i64, i64, i32p, i64, i64, i64,
                                         i64, i32p, i32p]
        lib.build_sg_sources.restype = None
        self.lib = lib
        return lib

    def compiler_version(self) -> str:
        """The first line of ``g++ --version`` ("" without g++)."""
        compiler = shutil.which("g++")
        if compiler is None:
            return ""
        return subprocess.run([compiler, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.splitlines()[0]


PLANNER = Planner()


def get_lib() -> Optional[ctypes.CDLL]:
    """The planner library, or None when ``SIGE_TPU_NO_NATIVE`` is set or
    there is no ``g++``."""
    if os.environ.get("SIGE_TPU_NO_NATIVE"):
        return None
    return PLANNER.load()


def available() -> bool:
    """Whether the core functions use the native library."""
    return get_lib() is not None


def _lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native planner is not in use "
                           "(SIGE_TPU_NO_NATIVE set, or no g++)")
    return lib


def _mask_u8(mask: np.ndarray) -> np.ndarray:
    m = np.ascontiguousarray(mask, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"the native planner takes 2-D masks, got "
                         f"{m.shape}")
    return m


def _indices_i32(indices: np.ndarray, count: int) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.int32)
    if idx.ndim != 2 or idx.shape[1] != 2 or not 0 <= count <= idx.shape[0]:
        raise ValueError(f"indices {idx.shape} with count {count}: expected "
                         f"[K, 2] and 0 <= count <= K")
    return idx


# ---- numpy-signature wrappers -------------------------------------------

def dilate_mask(mask: np.ndarray, dilation) -> np.ndarray:
    """:func:`sige_torch.core.masks.dilate_mask` of a 2-D mask."""
    dh, dw = ((dilation, dilation) if isinstance(dilation, (int, np.integer))
              else (int(dilation[0]), int(dilation[1])))
    m = _mask_u8(mask)
    out = np.empty_like(m)
    _lib().dilate_mask(m, out, m.shape[0], m.shape[1], dh, dw)
    return out.view(bool)


def _reduce(mask: np.ndarray, geom, indices: np.ndarray,
            sentinel: int) -> int:
    m = _mask_u8(mask)
    return int(_lib().reduce_mask(
        m, m.shape[0], m.shape[1],
        geom.block_size[0], geom.block_size[1],
        geom.block_stride[0], geom.block_stride[1],
        geom.offset[0], geom.offset[1],
        indices, indices.shape[0], np.int32(sentinel)))


def reduce_mask_padded(mask: np.ndarray, geom, capacity: int,
                       sentinel: int) -> Tuple[np.ndarray, int]:
    """([capacity, 2] int32 tile top-lefts padded with ``sentinel``, live
    count); rows past ``capacity`` are dropped, so callers check the count
    with :func:`count_tiles` first."""
    indices = np.empty((capacity, 2), np.int32)
    return indices, _reduce(mask, geom, indices, sentinel)


def count_tiles(mask: np.ndarray, geom) -> int:
    """The live tile count alone (a reduction into no rows)."""
    return _reduce(mask, geom, np.empty((0, 2), np.int32), 0)


def build_src_map(indices: np.ndarray, count: int, geom,
                  out_hw) -> np.ndarray:
    """:func:`sige_torch.core.scatter_map.build_src_map` over the first
    ``count`` rows of ``indices``."""
    H, W = out_hw
    idx = _indices_i32(indices, count)
    src = np.empty((H, W), np.int32)
    R, S = geom.out_tile_size
    _lib().build_src_map(idx, count, R, S,
                         geom.conv_stride[0], geom.conv_stride[1],
                         geom.offset[0], geom.offset[1], H, W,
                         src.reshape(-1))
    return src


def build_sg_sources(indices: np.ndarray, count: int, geom,
                     out_hw) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`sige_torch.core.scatter_map.build_sg_sources`: (sg_src,
    sg_flat), K * bh * bw each."""
    H, W = out_hw
    idx = _indices_i32(indices, count)
    src = build_src_map(idx, count, geom, out_hw)
    K = idx.shape[0]
    bh, bw = geom.block_size
    sg_src = np.empty(K * bh * bw, np.int32)
    sg_flat = np.empty(K * bh * bw, np.int32)
    _lib().build_sg_sources(idx, K, count, src.reshape(-1), H, W, bh, bw,
                            sg_src, sg_flat)
    return sg_src, sg_flat
