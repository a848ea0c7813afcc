"""Public EmbeddingBag API: CPU tensors → plain torch, CUDA → kernel, with
a backward on both."""

from __future__ import annotations

import torch

from repro_torch.kernels import device_kind
from repro_torch.kernels.embedding_bag import kernel as K
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_bwd_ref, embedding_bag_ref, table_rows,
)


class _EmbeddingBag(torch.autograd.Function):
    """The bag sum and its gradients: the table's by the backward kernel
    (CUDA) or its plain version (CPU), the weights' as a plain gather and
    sum, each only where ``needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, table, idx, wgt):
        cuda = device_kind("embedding_bag", table, idx, wgt) == "cuda"
        ctx.cuda, ctx.n_rows, ctx.dtype = cuda, table.shape[0], table.dtype
        ctx.save_for_backward(table if ctx.needs_input_grad[2] else None,
                              idx, wgt)
        if cuda:
            return K.embedding_bag(table, idx, wgt)
        return embedding_bag_ref(table, idx, wgt)

    @staticmethod
    def backward(ctx, grad_out):
        table, idx, wgt = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        g_table = g_wgt = None
        if ctx.needs_input_grad[0]:
            if ctx.cuda:
                g_table = K.embedding_bag_bwd(grad_out, idx, wgt,
                                              ctx.n_rows).to(ctx.dtype)
            else:
                g_table = embedding_bag_bwd_ref(grad_out, idx, wgt,
                                                ctx.n_rows, ctx.dtype)
        if ctx.needs_input_grad[2]:
            # d out[b] / d wgt[b, k] = the row the forward read
            rows = table[table_rows(idx, ctx.n_rows)].float()  # [B, K, D]
            g_wgt = (rows * grad_out.float()[:, None, :]).sum(-1)
        return g_table, None, g_wgt


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  wgt: torch.Tensor) -> torch.Tensor:
    """Sum-mode bag with per-sample weights:
    out[b] = Σ_k wgt[b, k] · table[idx[b, k]], [B, D] in the table's type
    (float32 accumulation).

    CUDA tensors launch the hand-written kernel (float32 / bfloat16 table,
    int32 indices, float32 weights); CPU tensors take the plain torch
    version; another device or a mix raises.  An index reads the row the
    reference op's ``table[idx]`` reads: a negative one wraps once, then
    it is clamped into [0, V - 1] (both paths; ``ref.table_rows``).

    Differentiable in the table and the weights.  The table's gradient is
    JAX's gradient of ``table[idx]``: accumulated in float32, rounded to
    the table's type once, and an index still out of range after the wrap
    adds nothing (JAX drops its cotangent; ``ref.live_rows``).  On CUDA
    tensors it launches the backward kernel."""
    return _EmbeddingBag.apply(table, idx, wgt)
