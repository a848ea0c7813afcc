"""Hand-written CUDA kernels for Hopper, with their plain torch versions.

Each kernel ships as

  <name>/csrc/*.cu - CUDA C++ for sm_90a with a plain C interface,
  <name>/kernel.py - the ctypes wrapper: checks, launch, and ``LIBS``
                     (each kernel's library name and sources),
  <name>/ref.py    - the plain torch version (CPU tests; held against the
                     kernel on the card),
  <name>/ops.py    - the public op: CPU tensors take the plain version,
                     CUDA tensors launch the kernel.  There is no fallback.

Kernels are compiled at first use with ``nvcc`` into ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``) and loaded with
``ctypes``.  Nothing is compiled or loaded when a module is imported.
Every launch goes through :func:`launch`, which counts it by kernel name
(:func:`launch_count`, :func:`reset_launch_counts`).

Each kernel's work — its operations and the least bytes it must move, the
figures its bound is computed from — is a formula of its arguments in
``<name>/cost.py``.  A public op reports one unit of that work through
:func:`work_scope` to the work counter active in the process
(``repro_torch.analysis.count``), on either path.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

#: Where built shared libraries go (inside the checkout, git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: The kernels, by the names their launches are counted under.
KERNELS = ("segment_fused", "segment_sum", "wedge_intersect", "embedding_bag",
           "embedding_bag_backward")

#: Launches of each kernel in this process, by kernel name.  The serving
#: layer launches from several worker threads, so updates take the lock.
_launches: collections.Counter[str] = collections.Counter()
_launches_lock = threading.Lock()
#: Held while a library is built and loaded: the serving layer's workers
#: may reach a kernel's first launch together, and a build's temporary
#: file is named by process, not by thread.
_load_lock = threading.Lock()


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


def build_many(libs: list[tuple[str, tuple[Path, ...]]]) -> list[Path]:
    """Compile every library of ``libs`` that is not built yet, one ``nvcc``
    process each, all started together; returns the libraries' paths.

    Each library is written under a temporary name and renamed into place,
    so processes that build concurrently never load a half-written file.
    """
    outs = [library_path(name, sources) for name, sources in libs]
    procs = []
    for (name, sources), out in zip(libs, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({proc.returncode}):\n"
                          f"{err}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str, sources: tuple[Path, ...]) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process
    (one thread at a time)."""
    with _load_lock:
        return _load(name, sources)


@functools.lru_cache(maxsize=None)
def _load(name: str, sources: tuple[Path, ...]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_many([(name, sources)])[0]))


def check(name: str, t: torch.Tensor, device: torch.device, ndim: int,
          dtypes: tuple[torch.dtype, ...] = (torch.int32,)) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D tensor of one of
    ``dtypes`` on ``device`` — what a kernel's C interface takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        want = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(kernel: str, device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA device: a kernel wrapper calls it
    after checking its arguments, so those checks also run on the CPU."""
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {device}")


def device_kind(op: str, *tensors: torch.Tensor | None) -> str:
    """Where a public op runs: ``"cuda"`` (launch the kernel) or ``"cpu"``
    (take the plain version) when every tensor given lies there; raises on
    another device or a mix.  ``None`` entries (absent payloads) are
    skipped."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds in ({"cuda"}, {"cpu"}):
        return kinds.pop()
    raise ValueError(f"{op} got tensors on {sorted(kinds)}; "
                     "expected all on the CPU or all on CUDA")


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream (no synchronisation); raise if it returns a CUDA error, else
    count one launch of ``kernel``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    with _launches_lock:
        _launches[kernel] += 1


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` in this process since the last reset."""
    with _launches_lock:
        return _launches[kernel]


def reset_launch_counts() -> None:
    with _launches_lock:
        _launches.clear()


class Work(NamedTuple):
    """One kernel call's work: ``ops`` operations of class ``op_class``
    (int32, fp32_add, fp32_fma) and the least ``bytes`` it moves (each
    input read once, each output written once)."""

    ops: int
    op_class: str
    bytes: int


#: Work counters active in this process, innermost last
#: (``analysis.count.WorkCounter`` registers itself while it is entered).
work_counters: list = []
_NO_SCOPE = contextlib.nullcontext()


def work_scope(kernel: str, work, *args, **kwargs):
    """The context of one public op call.  While a work counter is active
    it records one unit of ``kernel`` with ``work(*args, **kwargs)`` (the
    kernel's formula in ``<name>/cost.py``) and hides every aten op inside
    from the counter — the plain version's on the CPU, the wrapper's on the card —
    so both count the same.  With none active it is a shared no-op
    context: the formula is not evaluated."""
    if not work_counters:
        return _NO_SCOPE
    return work_counters[-1].kernel_scope(kernel, work, args, kwargs)
