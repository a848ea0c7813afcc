"""Public segment-reduction API: host-side CSR→blocked-ELL packing and the
device dispatch of the fused int32 reduction and of the float segment sum
(CPU → plain torch, CUDA → kernel)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import device_kind, work_scope
from repro_torch.kernels.segment_coo import kernel as K
from repro_torch.kernels.segment_coo.cost import (
    segment_fused_work, segment_sum_work,
)
from repro_torch.kernels.segment_coo.ref import (
    segment_fused_blocked_ref, segment_sum_blocked_ref,
)


def pack_blocks(
    row: np.ndarray, n_rows: int, *, r_blk: int = 8, e_blk_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host packing: row-sorted edge ids → (edge_perm [n_blocks, E_BLK],
    lrow [n_blocks, E_BLK]).  edge_perm indexes the original edge array;
    padding slots point at edge 0 with lrow = r_blk (ignored) — so the edge
    array must be non-empty (the partitioned graphs always pad E ≥ 1).
    ``e_blk_multiple`` rounds the edge budget up (sublane alignment)."""
    order = np.argsort(row, kind="stable")
    rs = row[order]
    n_blocks = (n_rows + r_blk - 1) // r_blk
    blk_of_edge = rs // r_blk
    counts = np.bincount(blk_of_edge, minlength=n_blocks)
    e_blk = max(int(counts.max(initial=1)), 1)
    e_blk = ((e_blk + e_blk_multiple - 1) // e_blk_multiple) * e_blk_multiple
    edge_perm = np.zeros((n_blocks, e_blk), dtype=np.int64)
    lrow = np.full((n_blocks, e_blk), r_blk, dtype=np.int32)
    starts = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for b in range(n_blocks):
        sl = slice(starts[b], starts[b + 1])
        k = starts[b + 1] - starts[b]
        edge_perm[b, :k] = order[sl]
        lrow[b, :k] = rs[sl] - b * r_blk
    return edge_perm, lrow, e_blk


def pack_blocks_stacked(
    rows: np.ndarray, n_rows: int, *, r_blk: int = 8, e_blk_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Stacked packing for the per-PE path: rows is [p, E]; every PE is
    packed against the same n_rows and padded to a SHARED E_BLK (max over
    PEs), so the per-PE plans stack into one [p, n_blocks, E_BLK] array
    that hands each rank its row."""
    packed = [pack_blocks(r, n_rows, r_blk=r_blk,
                          e_blk_multiple=e_blk_multiple) for r in rows]
    e_blk = max(pb[2] for pb in packed)
    n_blocks = packed[0][0].shape[0]
    edge_perm = np.zeros((len(packed), n_blocks, e_blk), dtype=np.int64)
    lrow = np.full((len(packed), n_blocks, e_blk), r_blk, dtype=np.int32)
    for i, (perm_i, lrow_i, eb_i) in enumerate(packed):
        edge_perm[i, :, :eb_i] = perm_i
        lrow[i, :, :eb_i] = lrow_i
    return edge_perm, lrow, e_blk


def _unblock(out: torch.Tensor, n_rows: int, batch: int = 1) -> torch.Tensor:
    """[(B,) n_blocks, R_BLK, D] → the first n_rows rows of each instance's
    [n_blocks*R_BLK, D], instances one after another: [B*n_rows, D]."""
    d = out.shape[-1]
    return out.reshape(batch, -1, d)[:, :n_rows].reshape(batch * n_rows, d)


def segment_sum_plain(
    data: torch.Tensor, edge_perm: torch.Tensor, lrow: torch.Tensor,
    n_rows: int, *, r_blk: int = 8,
) -> torch.Tensor:
    """Plain torch form of :func:`segment_sum_coo`: gather the payloads into
    [n_blocks, E_BLK, D] blocks, sum per block, unblock."""
    n_blocks, e_blk = edge_perm.shape
    blocked = data[edge_perm.reshape(-1).long()].reshape(
        n_blocks, e_blk, data.shape[-1])
    return _unblock(segment_sum_blocked_ref(blocked, lrow, r_blk=r_blk),
                    n_rows)


def segment_sum_coo(
    data: torch.Tensor,        # [E, D] float edge payloads (edge order)
    edge_perm: torch.Tensor,   # [n_blocks, E_BLK] from pack_blocks
    lrow: torch.Tensor,        # [n_blocks, E_BLK]
    n_rows: int,
    *,
    r_blk: int = 8,
    n_live: int | None = None,
) -> torch.Tensor:
    """Blocked segment sum; returns [n_rows, D] in data's type (float32
    accumulation, one rounding).

    CUDA tensors launch the hand-written kernel (payloads gathered inside
    it; float32 or bfloat16); CPU tensors take the plain torch version;
    meta tensors take it for the output's shape.  Anything else — another
    device, or a mix — raises.  ``n_live`` (the plan's live slots, known
    at packing) goes only to the work counter's formula, which needs it
    on meta tensors."""
    with work_scope("segment_sum", segment_sum_work, data, edge_perm, lrow,
                    n_rows, r_blk=r_blk, n_live=n_live):
        if device_kind("segment_sum_coo", data, edge_perm, lrow) == "cuda":
            return K.segment_sum(data, edge_perm, lrow, n_rows, r_blk=r_blk)
        return segment_sum_plain(data, edge_perm, lrow, n_rows, r_blk=r_blk)


def segment_fused_plain(
    edge_perm: torch.Tensor, lrow: torch.Tensor, n_rows: int, *,
    data_sum: torch.Tensor | None = None,
    data_max: torch.Tensor | None = None,
    data_min: torch.Tensor | None = None,
    data_or: torch.Tensor | None = None,
    or_nbits: int = 16, r_blk: int = 8,
):
    """Plain torch form of :func:`segment_fused_coo`: gather every payload
    group into [(B,) n_blocks, E_BLK, D*] blocks, reduce per block, unblock
    (per instance for a batch of plans)."""
    flat = edge_perm.long()
    batch = 1
    if edge_perm.dim() == 3:
        # instance b's edge ids index payload rows [b*E, (b+1)*E)
        batch = edge_perm.shape[0]
        n_edges = next(d.shape[0] for d in (data_sum, data_max, data_min,
                                            data_or) if d is not None)
        flat = flat + (torch.arange(batch, device=flat.device)
                       * (n_edges // batch))[:, None, None]
    flat = flat.reshape(-1)

    def gather(data):
        if data is None:
            return None
        return data[flat].reshape(*edge_perm.shape, data.shape[-1])

    outs = segment_fused_blocked_ref(
        gather(data_sum), gather(data_max), gather(data_min), lrow,
        data_or=gather(data_or), or_nbits=or_nbits, r_blk=r_blk,
    )
    return tuple(None if o is None else _unblock(o, n_rows, batch)
                 for o in outs)


def segment_fused_coo(
    edge_perm: torch.Tensor,   # [n_blocks, E_BLK] from pack_blocks
    lrow: torch.Tensor,        # [n_blocks, E_BLK]
    n_rows: int,
    *,
    data_sum: torch.Tensor | None = None,   # [E, Ds] edge payloads to sum
    data_max: torch.Tensor | None = None,   # [E, Dm] edge payloads to max
    data_min: torch.Tensor | None = None,   # [E, Dn] edge payloads to min
    data_or: torch.Tensor | None = None,    # [E, Do] payloads to bitwise-OR
    or_nbits: int = 16,                     # bit width of the OR payloads
    r_blk: int = 8,
    extent: torch.Tensor | None = None,     # [n_blocks] live extents
):
    """Fused blocked segment sum+max+min+or over one packed edge list;
    returns a (sum, max, min, or) tuple of [n_rows, D*] tensors (None where
    the payload group is absent).

    ``extent`` (``engine.SegPlan.extent``: one past each row block's last
    live slot) lets the kernel stop there; without it the kernel's wrapper
    derives it on each call (a sweep of every slot).  It does not change
    the result, and the plain version does not read it.

    A 3-D plan ``[B, n_blocks, E_BLK]`` is a batch of B same-shape plans
    (``engine.stack_plans``): payloads are [B*E, D*] with instance b's edges
    at [b*E, (b+1)*E), ``n_rows`` counts one instance's rows, and the
    outputs are [B*n_rows, D*].

    CUDA tensors launch the hand-written kernel (one pass, payloads gathered
    inside it); CPU tensors take the plain torch version.  Anything else —
    another device, or a mix — raises; so do meta tensors under a work
    counter, whose formula counts the live slots in ``lrow``."""
    groups = (data_sum, data_max, data_min, data_or)
    if all(d is None for d in groups):
        raise ValueError("segment_fused_coo needs at least one payload")
    kw = dict(data_sum=data_sum, data_max=data_max, data_min=data_min,
              data_or=data_or, or_nbits=or_nbits, r_blk=r_blk)
    with work_scope("segment_fused", segment_fused_work, edge_perm, lrow,
                    n_rows, **kw):
        if device_kind("segment_fused_coo", edge_perm, lrow, extent,
                       *groups) == "cuda":
            return K.segment_fused(edge_perm, lrow, n_rows, extent=extent,
                                   **kw)
        return segment_fused_plain(edge_perm, lrow, n_rows, **kw)
