"""ctypes wrappers of the blocked segment-reduction CUDA kernels.

``segment_fused`` is the Hopper counterpart of
``repro/kernels/segment_coo/kernel.py:segment_fused_blocked`` (int32
sum / max / min / OR, ``csrc/segment_fused.cu``), ``segment_sum`` that of
``segment_sum_blocked`` (float32 / bfloat16 sums, ``csrc/segment_sum.cu``);
each source says how it is laid out and what bounds it.  Both take the
*unblocked* ``[E, D]`` payloads and gather them through ``edge_perm``
inside the kernel.  ``segment_fused`` also takes each row block's live
extent (one past its last live slot, ``engine.SegPlan.extent``) and stops
there, and a batch of plans stacked on a leading axis (the serving layer's
stacked problems), one grid axis per instance.  CUDA tensors of the listed
types only: anything else raises, there is no fallback.  The plain versions are
:func:`repro_torch.kernels.segment_coo.ref.segment_fused_blocked_ref` and
:func:`~repro_torch.kernels.segment_coo.ref.segment_sum_blocked_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import check, launch, load, require_cuda
from repro_torch.kernels.segment_coo.ref import live_extent

_CSRC = Path(__file__).resolve().parent / "csrc"
#: Each kernel's (library name, sources), for ``kernels.build_many``.
LIBS = {
    "segment_fused": ("segment_fused", (_CSRC / "segment_fused.cu",)),
    "segment_sum": ("segment_sum", (_CSRC / "segment_sum.cu",)),
}
_ARGTYPES = {
    "segment_fused": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    "segment_sum": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}

#: Dynamic shared memory a segment_fused block takes without opting in.
_SMEM_LIMIT = 48 * 1024
#: The most instances one segment_fused launch takes (grid axis y).
_MAX_BATCH = 65_535
#: The largest r_blk segment_sum takes: one warp's shared memory
#: (``warp_smem`` in the source, at its widest vector of 4 columns a lane)
#: must fit the 227 KB a Hopper block may opt into, for every payload.
_SUM_MAX_R_BLK = 452
#: segment_sum's payload types and their code in the C interface.
_SUM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    fn = getattr(load(*LIBS[name]), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_plan(edge_perm, lrow, n_rows: int, r_blk: int,
                ndim: int = 2) -> torch.device:
    device = edge_perm.device
    check("edge_perm", edge_perm, device, ndim)
    check("lrow", lrow, device, ndim)
    if lrow.shape != edge_perm.shape:
        raise ValueError(
            f"lrow {tuple(lrow.shape)} != edge_perm {tuple(edge_perm.shape)}"
        )
    n_blocks = edge_perm.shape[-2]
    if not 0 < n_rows <= n_blocks * r_blk:
        raise ValueError(
            f"n_rows={n_rows} outside (0, n_blocks*r_blk={n_blocks * r_blk}]"
        )
    return device


def _sum_vec(data: torch.Tensor) -> int:
    """Columns a segment_sum lane reads at once: the widest of 4, 2 and 1
    that divides the row (so every row keeps the payload pointer's
    alignment), that the pointer is aligned to (a view may start at any
    element), and that 32 lanes do not overrun (a narrow row keeps a warp's
    lanes busy)."""
    d, size = data.shape[1], data.element_size()
    for vec in (4, 2):
        if d % vec == 0 and data.data_ptr() % (vec * size) == 0 \
                and 32 * vec <= d:
            return vec
    return 1


def segment_fused(
    edge_perm: torch.Tensor,   # [(B,) n_blocks, E_BLK] i32 edge ids
    lrow: torch.Tensor,        # [(B,) n_blocks, E_BLK] i32 local rows
    n_rows: int,
    *,
    r_blk: int,
    data_sum: torch.Tensor | None = None,   # [(B*)E, Ds] i32
    data_max: torch.Tensor | None = None,   # [(B*)E, Dm] i32
    data_min: torch.Tensor | None = None,   # [(B*)E, Dn] i32
    data_or: torch.Tensor | None = None,    # [(B*)E, Do] i32
    or_nbits: int = 16,
    extent: torch.Tensor | None = None,     # [(B,) n_blocks] i32
):
    """Launch the kernel on the current stream; returns a (sum, max, min,
    or) tuple of [n_rows, D*] int32 tensors (None for absent groups).
    Does not synchronise.

    ``extent`` is one past each row block's last live slot (the plan's
    ``SegPlan.extent``, which every plan carries); the kernel reads no
    slot after it.  A bare call without it (``ops.segment_fused_coo`` on
    arrays that are not a ``SegPlan``) derives it from ``lrow`` on the
    device (:func:`live_extent`), a sweep of every slot on each call.

    A 3-D plan is a batch of B plans of one shape (``engine.stack_plans``):
    instance b's edge ids index payload rows [b*E, (b+1)*E) with
    E = payload rows / B, ``n_rows`` counts one instance's rows, and the
    outputs are [B*n_rows, D*], instance b's rows at [b*n_rows, ...)."""
    if not 0 < or_nbits < 32:
        raise ValueError(f"or_nbits must be in (0, 32), got {or_nbits}")
    groups = (data_sum, data_max, data_min, data_or)
    if all(d is None for d in groups):
        raise ValueError("segment_fused needs at least one payload")
    batched = edge_perm.dim() == 3
    device = _check_plan(edge_perm, lrow, n_rows, r_blk, 3 if batched else 2)
    batch = edge_perm.shape[0] if batched else 1
    if not 0 < batch <= _MAX_BATCH:
        raise ValueError(f"batch {batch} outside (0, {_MAX_BATCH}]")
    n_blocks, e_blk = edge_perm.shape[-2:]
    if extent is not None:
        check("extent", extent, device, edge_perm.dim() - 1)
        if extent.shape != edge_perm.shape[:-1]:
            raise ValueError(f"extent {tuple(extent.shape)} != the plan's "
                             f"row blocks {tuple(edge_perm.shape[:-1])}")
    n_edges = None
    for name, d in zip(("data_sum", "data_max", "data_min", "data_or"),
                       groups):
        if d is None:
            continue
        check(name, d, device, 2)
        if n_edges is not None and d.shape[0] != n_edges:
            raise ValueError(f"{name} has {d.shape[0]} edges, expected "
                             f"{n_edges}")
        n_edges = d.shape[0]
    if n_edges % batch:
        raise ValueError(f"{n_edges} payload rows do not split into "
                         f"{batch} instances")
    widths = [0 if d is None else d.shape[1] for d in groups]
    smem = 4 * r_blk * sum(widths)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"r_blk={r_blk} x {sum(widths)} payload columns "
                         f"needs {smem} B of shared memory (> {_SMEM_LIMIT})")
    require_cuda("segment_fused", device)
    if extent is None:
        extent = live_extent(lrow, r_blk)
    outs = [
        None if d is None else torch.empty(
            (batch * n_rows, d.shape[1]), dtype=torch.int32, device=device
        )
        for d in groups
    ]

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch("segment_fused", _launcher("segment_fused"), device,
           edge_perm.data_ptr(), lrow.data_ptr(), extent.data_ptr(),
           *(ptr(d) for d in groups), *(ptr(o) for o in outs),
           batch, n_blocks, e_blk, r_blk, n_rows, n_edges // batch, *widths,
           or_nbits)
    return tuple(outs)


def segment_sum(
    data: torch.Tensor,        # [E, D] float32 / bfloat16 edge payloads
    edge_perm: torch.Tensor,   # [n_blocks, E_BLK] i32 edge ids (pack_blocks)
    lrow: torch.Tensor,        # [n_blocks, E_BLK] i32 local rows (R_BLK = pad)
    n_rows: int,
    *,
    r_blk: int,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns the [n_rows, D]
    per-row sums in ``data``'s type (float32 accumulation, one rounding).
    Does not synchronise."""
    device = _check_plan(edge_perm, lrow, n_rows, r_blk)
    check("data", data, device, 2, tuple(_SUM_DTYPES))
    n_blocks, e_blk = edge_perm.shape
    d = data.shape[1]
    if data.shape[0] == 0 or d == 0:
        raise ValueError(f"segment_sum needs a non-empty [E, D] payload, got "
                         f"{tuple(data.shape)}")
    if r_blk > _SUM_MAX_R_BLK:
        raise ValueError(f"r_blk={r_blk} does not fit a block's shared memory "
                         f"(at most {_SUM_MAX_R_BLK})")
    require_cuda("segment_sum", device)
    out = torch.empty((n_rows, d), dtype=data.dtype, device=device)
    launch("segment_sum", _launcher("segment_sum"), device,
           edge_perm.data_ptr(), lrow.data_ptr(), data.data_ptr(),
           out.data_ptr(), n_blocks, e_blk, r_blk, n_rows, d,
           _SUM_DTYPES[data.dtype], _sum_vec(data))
    return out
