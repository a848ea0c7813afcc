"""Plain torch version of the sum-mode EmbeddingBag.

A copy of ``repro/kernels/embedding_bag/ref.py`` over torch tensors: gather,
weight, sum over the bag in float32, round to the table's type once.  It is
the plain version of the hand-written CUDA kernel in
:mod:`repro_torch.kernels.embedding_bag.kernel`: the CPU path, and what the
kernel is held against on the card.
"""

from __future__ import annotations

import torch


def table_rows(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The rows JAX's ``table[idx]`` reads (int64): a negative index wraps
    once (+ ``n_rows``), then every index is clamped into
    [0, n_rows - 1], so -V - 1 reads row 0 and V + 3 row V - 1."""
    i = idx.long()
    return torch.where(i < 0, i + n_rows, i).clamp_(0, n_rows - 1)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      wgt: torch.Tensor) -> torch.Tensor:
    """out[b] = Σ_k wgt[b, k] · table[idx[b, k]]: [V, D], [B, K], [B, K] →
    [B, D] in the table's type; out-of-range indices as ``table_rows``."""
    rows = table[table_rows(idx, table.shape[0])]    # [B, K, D]
    return (rows.float() * wgt[..., None].float()).sum(1).to(table.dtype)


def live_rows(idx: torch.Tensor, n_rows: int):
    """(rows, live) of the gradient of ``table[idx]``: a negative index
    wraps once (+ ``n_rows``); one still outside [0, n_rows) after the wrap
    is not live.  JAX's gather transposes to a scatter that drops such an
    index's cotangent: the forward clamps it, its gradient is dropped."""
    i = idx.long()
    i = torch.where(i < 0, i + n_rows, i)
    return i, (i >= 0) & (i < n_rows)


def embedding_bag_bwd_ref(grad_out: torch.Tensor, idx: torch.Tensor,
                          wgt: torch.Tensor, n_rows: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """The table's gradient of :func:`embedding_bag_ref`: [B, D] cotangent,
    [B, K] indices and weights → [n_rows, D] in ``dtype``, where row r is
    Σ wgt[b, k] · grad_out[b] over the live lookups (``live_rows``) of r,
    accumulated in float32 and rounded to ``dtype`` once.  A lookup that
    is not live adds nothing, whatever its weight (NaN included)."""
    rows, live = live_rows(idx, n_rows)
    terms = grad_out.float()[:, None, :] * wgt.float()[..., None]  # [B,K,D]
    grad = torch.zeros((n_rows, grad_out.shape[1]), dtype=torch.float32,
                       device=grad_out.device)
    grad.index_add_(0, rows[live], terms[live])
    return grad.to(dtype)
