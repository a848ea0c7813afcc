"""The work of the EmbeddingBag kernels as formulas of their arguments:
what ``chip_smoke.py`` bounds each call by and what a work counter
(``repro_torch.analysis.count``) records a call as."""

from __future__ import annotations

import torch

from repro_torch.kernels import Work
from repro_torch.kernels.embedding_bag.ref import live_rows


def embedding_bag_work(table: torch.Tensor, idx: torch.Tensor,
                       wgt: torch.Tensor) -> Work:
    """One float32 FMA a looked-up element.  Least bytes: one table row,
    one index and one weight a lookup, one output row a bag."""
    n_bags, k = idx.shape
    d, es = table.shape[1], table.element_size()
    return Work(n_bags * k * d, "fp32_fma",
                n_bags * k * (d * es + 8) + n_bags * d * es)


def embedding_bag_bwd_work(grad_out: torch.Tensor, idx: torch.Tensor,
                           wgt: torch.Tensor, n_rows: int) -> Work:
    """One float32 FMA a live looked-up element.  Least bytes: the
    cotangent once, the indices and weights, each touched row of the
    float32 gradient read and written once."""
    rows, live = live_rows(idx, n_rows)
    touched = int(torch.unique(rows[live]).shape[0])
    d = grad_out.shape[1]
    return Work(int(live.sum()) * d, "fp32_fma",
                grad_out.numel() * grad_out.element_size() + idx.numel() * 8
                + 2 * touched * d * 4)
