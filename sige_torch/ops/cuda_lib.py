"""Build and load a hand-written CUDA source of the port as a shared
library with a plain C interface.

Each source under ``sige_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` on first use into ``build/sige_torch/`` (beside the package,
ignored by git) under a name that carries a digest of the source bytes
and the flags, so an edited source is rebuilt and an unchanged one is
found built; the library is built under a temporary name and then
``os.replace``d, so processes building at once are safe. It is loaded
with ctypes, and every C entry gets its declared argument and result
types. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sige_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Signature = Tuple[Sequence, object]  # (argtypes, restype)


def nvcc() -> str:
    """The CUDA compiler: under ``CUDA_HOME``, ``/usr/local/cuda`` or on
    ``PATH``."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels build with "
                           "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


class CudaLibrary:
    """One compiled kernel source, built and loaded on first use.
    ``entries`` maps each C entry's name to its ctypes signature; after
    :meth:`load` they are attributes of the same names, ``path`` is the
    library and ``build_log`` nvcc's output (empty when it was found
    built)."""

    def __init__(self, source: Path, stem: str,
                 entries: Dict[str, Signature]):
        self.source = Path(source)
        self.stem = stem
        self.entries = entries
        self.path: Optional[Path] = None
        self.build_log = ""
        self._fns: Optional[Dict[str, object]] = None

    def build(self) -> Path:
        """Compile the source (skipped when a library built from the same
        source bytes and flags exists) and return the library's path."""
        src = self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        digest = hashlib.sha256(src).hexdigest()
        out = BUILD_DIR / f"lib{self.stem}_{digest[:12]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, out)
        return out

    def load(self) -> "CudaLibrary":
        """Build if needed and bind every entry; returns self."""
        if self._fns is None:
            self.path = self.build()
            lib = ctypes.CDLL(str(self.path))
            fns = {}
            for name, (argtypes, restype) in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
                fns[name] = fn
            self._fns = fns
        return self

    def __getattr__(self, name):
        fns = self.__dict__.get("_fns")
        if fns is not None and name in fns:
            return fns[name]
        raise AttributeError(name)
