"""The work of the two segment kernels as formulas of their arguments:
what ``chip_smoke.py`` bounds each call by and what a work counter
(``repro_torch.analysis.count``) records a call as."""

from __future__ import annotations

import torch

from repro_torch.kernels import Work, require_host_figure


def _live(lrow: torch.Tensor, r_blk: int, n_live: int | None = None,
          kernel: str = "segment_fused") -> int:
    """Plan slots that hold an edge (padding slots have lrow = r_blk):
    ``n_live`` where the caller knows it from packing, else counted in
    ``lrow`` (which a meta tensor cannot be: it raises)."""
    if n_live is not None:
        return int(n_live)
    require_host_figure(kernel, "n_live (the plan's live slots)", lrow)
    return int(((lrow >= 0) & (lrow < r_blk)).sum())


def _fused_shape(edge_perm, lrow, n_rows, r_blk, payloads):
    """(live slots, payload columns, payload rows, output rows)."""
    groups = [d for d in payloads if d is not None]
    batch = edge_perm.shape[0] if edge_perm.dim() == 3 else 1
    return (_live(lrow, r_blk), sum(d.shape[1] for d in groups),
            groups[0].shape[0], batch * n_rows)


def segment_fused_work(edge_perm: torch.Tensor, lrow: torch.Tensor,
                       n_rows: int, *, data_sum=None, data_max=None,
                       data_min=None, data_or=None, r_blk: int = 8,
                       **_) -> Work:
    """One int32 add / max / min / or a live slot and payload column.
    Least bytes over the plan: lrow at every slot, each live slot's edge
    id, every payload once and the [(B ×) n_rows, cols] outputs once."""
    live, cols, n_edges, out_rows = _fused_shape(
        edge_perm, lrow, n_rows, r_blk,
        (data_sum, data_max, data_min, data_or))
    return Work(live * cols, "int32",
                4 * (lrow.numel() + live + (n_edges + out_rows) * cols))


def segment_fused_live_bytes(edge_perm: torch.Tensor, lrow: torch.Tensor,
                             n_rows: int, *, data_sum=None, data_max=None,
                             data_min=None, data_or=None, r_blk: int = 8,
                             **_) -> int:
    """The least bytes over the live slots only: each row block's extent,
    a live slot's row and edge id, the payloads and the outputs once."""
    live, cols, n_edges, out_rows = _fused_shape(
        edge_perm, lrow, n_rows, r_blk,
        (data_sum, data_max, data_min, data_or))
    n_blocks = lrow.numel() // lrow.shape[-1]
    return 4 * (n_blocks + 2 * live + (n_edges + out_rows) * cols)


def segment_sum_work(data: torch.Tensor, edge_perm: torch.Tensor,
                     lrow: torch.Tensor, n_rows: int, *, r_blk: int = 8,
                     n_live: int | None = None) -> Work:
    """One float32 add a live slot and payload column.  Least bytes: lrow
    at every slot, each live slot's edge id and payload row, the
    [n_rows, D] output once.  ``n_live``: the live slots, where the
    caller knows them (``ScatterPlan.n_live``); on meta tensors it must."""
    live = _live(lrow, r_blk, n_live, "segment_sum")
    d, es = data.shape[-1], data.element_size()
    return Work(live * d, "fp32_add",
                4 * lrow.numel() + 4 * live + es * d * (live + n_rows))
