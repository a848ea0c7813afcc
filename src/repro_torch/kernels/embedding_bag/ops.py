"""Public EmbeddingBag API: CPU tensors → plain torch, CUDA → kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels import device_kind
from repro_torch.kernels.embedding_bag import kernel as K
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  wgt: torch.Tensor) -> torch.Tensor:
    """Sum-mode bag with per-sample weights:
    out[b] = Σ_k wgt[b, k] · table[idx[b, k]], [B, D] in the table's type
    (float32 accumulation).

    CUDA tensors launch the hand-written kernel (float32 / bfloat16 table,
    int32 indices, float32 weights); CPU tensors take the plain torch
    version; another device or a mix raises.  An index reads the row the
    reference op's ``table[idx]`` reads: a negative one wraps once, then
    it is clamped into [0, V - 1] (both paths; ``ref.table_rows``)."""
    if device_kind("embedding_bag", table, idx, wgt) == "cuda":
        return K.embedding_bag(table, idx, wgt)
    return embedding_bag_ref(table, idx, wgt)
