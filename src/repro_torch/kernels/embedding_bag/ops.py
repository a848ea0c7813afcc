"""Public EmbeddingBag API: CPU tensors → plain torch, CUDA → kernel, with
a backward on both."""

from __future__ import annotations

import torch

from repro_torch import is_dtensor
from repro_torch.kernels import device_kind, work_scope
from repro_torch.kernels.embedding_bag import kernel as K
from repro_torch.kernels.embedding_bag.cost import (
    embedding_bag_bwd_work, embedding_bag_work,
)
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_bwd_ref, embedding_bag_ref, table_rows,
)


class _EmbeddingBag(torch.autograd.Function):
    """The bag sum and its gradients: the table's by the backward kernel
    (CUDA) or its plain version (CPU), the weights' as a plain gather and
    sum, each only where ``needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, table, idx, wgt, host_idx, block=None):
        kind = device_kind("embedding_bag", table, idx, wgt)
        ctx.kind, ctx.n_rows, ctx.dtype = kind, table.shape[0], table.dtype
        ctx.host_idx, ctx.block = host_idx, block
        ctx.save_for_backward(table if ctx.needs_input_grad[2] else None,
                              idx, wgt)
        with work_scope("embedding_bag", embedding_bag_work, table, idx,
                        wgt):
            if kind == "cuda":
                return K.embedding_bag(table, idx, wgt)
            return embedding_bag_ref(table, idx, wgt)

    @staticmethod
    def backward(ctx, grad_out):
        table, idx, wgt = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        g_table = g_wgt = None
        if ctx.needs_input_grad[0]:
            with work_scope("embedding_bag_backward", embedding_bag_bwd_work,
                            grad_out, idx, wgt, ctx.n_rows, ctx.host_idx,
                            ctx.block):
                if ctx.kind == "cuda":
                    g_table = K.embedding_bag_bwd(grad_out, idx, wgt,
                                                  ctx.n_rows).to(ctx.dtype)
                elif ctx.kind == "meta":
                    # the plain version drops dead lookups by a mask, whose
                    # count meta tensors lack; its output's shape is this
                    g_table = grad_out.new_empty(
                        (ctx.n_rows, grad_out.shape[1]), dtype=ctx.dtype)
                else:
                    g_table = embedding_bag_bwd_ref(grad_out, idx, wgt,
                                                    ctx.n_rows, ctx.dtype)
        if ctx.needs_input_grad[2]:
            # d out[b] / d wgt[b, k] = the row the forward read
            rows = table[table_rows(idx, ctx.n_rows)].float()  # [B, K, D]
            g_wgt = (rows * grad_out.float()[:, None, :]).sum(-1)
        return g_table, None, g_wgt, None, None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  wgt: torch.Tensor,
                  host_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Sum-mode bag with per-sample weights:
    out[b] = Σ_k wgt[b, k] · table[idx[b, k]], [B, D] in the table's type
    (float32 accumulation).

    CUDA tensors launch the hand-written kernel (float32 / bfloat16 table,
    int32 indices, float32 weights); CPU tensors take the plain torch
    version (on meta tensors for the output's shape); another device or a
    mix raises.  An index reads the row the
    reference op's ``table[idx]`` reads: a negative one wraps once, then
    it is clamped into [0, V - 1] (both paths; ``ref.table_rows``).

    Differentiable in the table and the weights.  The table's gradient is
    JAX's gradient of ``table[idx]``: accumulated in float32, rounded to
    the table's type once, and an index still out of range after the wrap
    adds nothing (JAX drops its cotangent; ``ref.live_rows``).  On CUDA
    tensors it launches the backward kernel.

    ``host_idx``, a CPU copy of ``idx``, goes only to the work counter's
    backward formula, which counts the touched rows in it (it must have
    one on meta tensors).

    A DTensor ``table`` takes :func:`_sharded_embedding_bag`."""
    if is_dtensor(table):
        return _sharded_embedding_bag(table, idx, wgt, host_idx)
    return _EmbeddingBag.apply(table, idx, wgt, host_idx)


def _local(x, places):
    """``x`` (a DTensor, or a plain tensor taken as replicated) laid out
    by ``places``, as its local tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, places).to_local()


def _sharded_embedding_bag(table, idx, wgt, host_idx):
    """The op's sharding rule for a DTensor ``table``, one device's
    call on its local tensors, as DTensor's rule for ``aten.embedding``.

    A table sharded by rows (``Shard(0)`` on some mesh dims; DLRM's big
    tables): the ids and weights replicated, each device looks every bag
    up in its block of rows, a lookup outside the block with weight 0,
    and the output is a partial sum over those mesh dims.  A replicated
    table: each device looks up its own bags (the ids' layout), and the
    table's gradient is a partial sum over the dims that shard the ids.
    The op's semantics hold for ids in [-V, V), V the whole table's rows;
    an id outside adds 0 here (NaN on one device).  The work formulas
    count the local call: every replicated bag against the block, the
    backward's live lookups and touched rows those of the block
    (``cost.embedding_bag_bwd_work``'s ``block``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    if any(p.is_shard() and p.dim != 0 for p in table.placements):
        raise NotImplementedError(
            f"embedding_bag shards a table by rows only, got "
            f"{table.placements}")
    on = [i for i, p in enumerate(table.placements) if p.is_shard()]
    if not on:
        places = (idx.placements if isinstance(idx, DTensor)
                  else (Replicate(),) * mesh.ndim)
        grad = tuple(Partial() if p.is_shard() else Replicate()
                     for p in places)
        out = _EmbeddingBag.apply(table.to_local(grad_placements=grad),
                                  _local(idx, places), _local(wgt, places),
                                  host_idx)
        return DTensor.from_local(out, mesh, places, run_check=False,
                                  shape=(idx.shape[0], table.shape[1]),
                                  stride=(table.shape[1], 1))
    rep = (Replicate(),) * mesh.ndim
    il, wl = _local(idx, rep), _local(wgt, rep)
    tl = table.to_local()
    n, total = tl.shape[0], table.shape[0]
    block = 0
    for i in on:   # mesh-dim order, as DTensor cuts a dim sharded twice
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    lo = block * n
    rows = torch.where(il < 0, il + total, il) - lo
    hit = (rows >= 0) & (rows < n)
    out = _EmbeddingBag.apply(
        tl, torch.where(hit, rows, n).to(il.dtype),
        torch.where(hit, wl, 0.0), host_idx, (lo, total))
    return DTensor.from_local(
        out, mesh, tuple(Partial() if i in on else Replicate()
                         for i in range(mesh.ndim)),
        run_check=False, shape=(idx.shape[0], table.shape[1]),
        stride=(table.shape[1], 1))
