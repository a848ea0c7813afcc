"""Hand-written CUDA kernels for Hopper, with their plain torch versions.

Each kernel ships as

  <name>/csrc/*.cu - CUDA C++ for sm_90a with a plain C interface,
  <name>/kernel.py - the ctypes wrapper: checks, launch, launch counter,
  <name>/ref.py    - the plain torch version (CPU tests; held against the
                     kernel on the card),
  <name>/ops.py    - the public op: CPU tensors take the plain version,
                     CUDA tensors launch the kernel.  There is no fallback.

Kernels are compiled at first use with ``nvcc`` into ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``) and loaded with
``ctypes``.  Nothing is compiled or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: Where built shared libraries go (inside the checkout, git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, sources: tuple[Path, ...]) -> Path:
    """Content-addressed .so path: a changed source or flag rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, sources: tuple[Path, ...]) -> Path:
    """Compile ``sources`` into one shared library unless already built.

    The library is written under a temporary name and renamed into place, so
    processes that build concurrently never load a half-written file.
    """
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} ({res.returncode}):\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, sources: tuple[Path, ...]) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    return ctypes.CDLL(str(build(name, sources)))
