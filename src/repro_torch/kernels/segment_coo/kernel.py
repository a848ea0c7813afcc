"""ctypes wrapper of the fused blocked segment-reduction CUDA kernel.

``segment_fused`` is the Hopper counterpart of
``repro/kernels/segment_coo/kernel.py:segment_fused_blocked``
(``csrc/segment_fused.cu`` says how it is laid out and what bounds it).
It takes the *unblocked* ``[E, D*]`` payloads and gathers them through
``edge_perm`` inside the kernel.  CUDA int32 tensors only: anything else
raises, there is no fallback.  The plain version is
:func:`repro_torch.kernels.segment_coo.ref.segment_fused_blocked_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import load

SOURCES = (Path(__file__).resolve().parent / "csrc" / "segment_fused.cu",)

#: Launches of the kernel in this process (see :func:`launch_count`).
_launches = 0

#: Dynamic shared memory a block may take without opting in (bytes).
_SMEM_LIMIT = 48 * 1024


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("segment_fused", SOURCES).segment_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the kernel library (first use does it anyway)."""
    _launcher()


def _check(name: str, t: torch.Tensor, device: torch.device, ndim: int):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def segment_fused(
    edge_perm: torch.Tensor,   # [n_blocks, E_BLK] i32 edge ids (pack_blocks)
    lrow: torch.Tensor,        # [n_blocks, E_BLK] i32 local rows (R_BLK = pad)
    n_rows: int,
    *,
    r_blk: int,
    data_sum: torch.Tensor | None = None,   # [E, Ds] i32
    data_max: torch.Tensor | None = None,   # [E, Dm] i32
    data_min: torch.Tensor | None = None,   # [E, Dn] i32
    data_or: torch.Tensor | None = None,    # [E, Do] i32
    or_nbits: int = 16,
):
    """Launch the kernel on the current stream; returns a (sum, max, min,
    or) tuple of [n_rows, D*] int32 tensors (None for absent groups).
    Does not synchronise."""
    global _launches
    if not 0 < or_nbits < 32:
        raise ValueError(f"or_nbits must be in (0, 32), got {or_nbits}")
    groups = (data_sum, data_max, data_min, data_or)
    if all(d is None for d in groups):
        raise ValueError("segment_fused needs at least one payload")
    device = edge_perm.device
    if device.type != "cuda":
        raise ValueError(f"segment_fused runs on CUDA tensors, got {device}")
    _check("edge_perm", edge_perm, device, 2)
    _check("lrow", lrow, device, 2)
    if lrow.shape != edge_perm.shape:
        raise ValueError(
            f"lrow {tuple(lrow.shape)} != edge_perm {tuple(edge_perm.shape)}"
        )
    n_blocks, e_blk = edge_perm.shape
    if not 0 < n_rows <= n_blocks * r_blk:
        raise ValueError(
            f"n_rows={n_rows} outside (0, n_blocks*r_blk={n_blocks * r_blk}]"
        )
    n_edges = None
    for name, d in zip(("data_sum", "data_max", "data_min", "data_or"),
                       groups):
        if d is None:
            continue
        _check(name, d, device, 2)
        if n_edges is not None and d.shape[0] != n_edges:
            raise ValueError(f"{name} has {d.shape[0]} edges, expected "
                             f"{n_edges}")
        n_edges = d.shape[0]
    widths = [0 if d is None else d.shape[1] for d in groups]
    smem = 4 * r_blk * sum(widths)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"r_blk={r_blk} x {sum(widths)} payload columns "
                         f"needs {smem} B of shared memory (> {_SMEM_LIMIT})")
    outs = [
        None if d is None else torch.empty(
            (n_rows, d.shape[1]), dtype=torch.int32, device=device
        )
        for d in groups
    ]

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher()(
            edge_perm.data_ptr(), lrow.data_ptr(),
            *(ptr(d) for d in groups), *(ptr(o) for o in outs),
            n_blocks, e_blk, r_blk, n_rows, *widths, or_nbits, stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_fused launch failed: CUDA error {err}")
    _launches += 1
    return tuple(outs)
