"""The DTensor rules of the dry-run's sharded count.

Where DTensor's own rules for an op fail, are wrong for the layout GSPMD
gives the reference's program, or take minutes on the three-axis mesh,
the model functions of ``models.common``, ``models.transformer`` and
``models.dlrm`` hand their DTensor operands here (each checks
``repro_torch.is_dtensor`` and takes its one-device path otherwise): each
rule runs one rank's local ops on its shards and says how the result is
laid out.  This module is loaded where a DTensor first reaches a model,
so no run on one device imports it.

  * :func:`einsum` — a two-operand einsum partitioned as GSPMD partitions
    a dot;
  * :func:`flash_attention` — each rank's query heads against their key /
    value groups;
  * :func:`logsumexp`, :func:`take` — the tied head's loss over a sharded
    vocabulary;
  * :func:`lookup`, :func:`split_heads`, :func:`take_pairs` — the
    embedding lookup, the heads' split, DLRM's interaction pairs;
  * :func:`laid_out_as`, :func:`write_rows` — the decode cache's write;
  * :func:`moe_dispatch`, :func:`moe_combine`, :func:`replicated` — the
    MoE routing;
  * :func:`block_of`, :func:`partial_over` — a rank's block of a dim and
    the partial layout of what each rank fills from its block.

The ``embedding_bag`` op's rule sits with the op
(``kernels/embedding_bag/ops.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.nn import functional as F

from repro_torch import is_dtensor
from repro_torch.models import common as C


def einsum(eq: str, a, b):
    """A two-operand einsum of DTensors (a plain operand counts as
    replicated), each rank's ``torch.einsum`` on its local operands.

    Mesh dim by mesh dim, as GSPMD partitions a dot: a partial operand is
    reduced first; where one operand is sharded along a letter the other
    holds whole, the other is cut the same way (no transfer) and the
    output is sharded along that letter, or is a partial sum where the
    letter is contracted; where the two are sharded along different
    letters, the smaller local operand is gathered on that mesh dim.
    (DTensor's own rule for ``bmm`` searches every placement of every
    operand, which takes minutes an op on the three-axis mesh.)  The
    gradients come back as the same layouts, the one of an operand that
    did not hold a letter sharding the output as a partial sum."""
    ins, out_letters = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    mesh = (a if is_dtensor(a) else b).device_mesh

    def as_dt(x):
        if is_dtensor(x):
            return x
        return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False)

    a, b = as_dt(a), as_dt(b)
    pa, pb = list(a.placements), list(b.placements)
    for m in range(mesh.ndim):
        pa[m] = Replicate() if pa[m].is_partial() else pa[m]
        pb[m] = Replicate() if pb[m].is_partial() else pb[m]

    def cut(p) -> bool:    # Shard, or the _StridedShard of a flattened dim
        return hasattr(p, "dim")

    def letter(p, letters):
        return letters[p.dim] if cut(p) else None

    def moved(p, dim):     # p's kind of cut, on another dim
        return (Shard(dim) if type(p) is Shard
                else type(p)(dim, split_factor=p.split_factor))

    def nbytes(x):
        local = x.to_local()
        return local.numel() * local.element_size()

    out = []
    for m in range(mesh.ndim):
        xa, xb = letter(pa[m], la), letter(pb[m], lb)
        if xa is not None and xb is not None and xa != xb:
            if nbytes(a) <= nbytes(b):
                pa[m], xa = Replicate(), None
            else:
                pb[m], xb = Replicate(), None
        x = xa or xb
        if x is None:
            out.append(Replicate())
            continue
        src = pa[m] if xa is not None else pb[m]
        if xa is None and x in lb and x in la:
            pa[m] = moved(src, la.index(x))
        if xb is None and x in la and x in lb:
            pb[m] = moved(src, lb.index(x))
        out.append(moved(src, out_letters.index(x)) if x in out_letters
                   else Partial())
    a = a.redistribute(mesh, tuple(pa)) if tuple(pa) != a.placements else a
    b = b.redistribute(mesh, tuple(pb)) if tuple(pb) != b.placements else b

    def grads(places, letters):
        return tuple(
            p if cut(p) else
            Partial() if cut(o) and out_letters[o.dim] not in letters
            else Replicate() for p, o in zip(places, out))

    local = torch.einsum(eq, a.to_local(grad_placements=grads(pa, la)),
                         b.to_local(grad_placements=grads(pb, lb)))
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    shape = tuple(size[c] for c in out_letters)
    return DTensor.from_local(local, mesh, tuple(out), run_check=False,
                              shape=torch.Size(shape),
                              stride=C.contiguous_strides(shape))


def laid_out_as(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` redistributed to the placements of ``ref`` (a
    DTensor of as many dims), but replicated where ``ref`` shards dim 1
    (the decode cache's sequence, of which ``x`` holds one step)."""
    places = tuple(Replicate() if hasattr(p, "dim") and p.dim == 1 else p
                   for p in ref.placements)
    if tuple(x.placements) == places:
        return x
    return x.redistribute(ref.device_mesh, places)


def write_rows(cache: torch.Tensor, new: torch.Tensor, pos0: int) -> None:
    """``cache[:, pos0:pos0 + T] = new`` (T = ``new.shape[1]``) of a
    DTensor cache, in place on each rank's shard: ``new`` laid out as the
    cache (:func:`laid_out_as`), and where the cache shards its sequence,
    only the rank whose block holds the rows writes them."""
    mesh = cache.device_mesh
    local, rows = cache.to_local(), laid_out_as(new, cache).to_local()
    on = [i for i, p in enumerate(cache.placements)
          if hasattr(p, "dim") and p.dim == 1]
    block = 0
    for i in on:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    lo = block * local.shape[1]
    a, b = max(pos0, lo), min(pos0 + rows.shape[1], lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = rows[:, a - pos0:b - pos0]


def lookup(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` (rows in range) of a DTensor table, through
    ``F.embedding``, whose DTensor rule looks a row-sharded table up
    block by block into a masked partial sum (the index rule would
    gather the table whole)."""
    return F.embedding(rows, table)


def split_heads(x: torch.Tensor, heads: int, d_head: int) -> torch.Tensor:
    """A DTensor ``x`` [..., heads · d_head] as [..., heads, d_head]; one
    whose last dim is cut into more blocks than ``heads`` divides into is
    gathered on those mesh dims first (DTensor cuts the head dim only;
    GSPMD would cut heads and d_head both)."""
    mesh, last = x.device_mesh, x.ndim - 1
    on = [i for i, p in enumerate(x.placements)
          if hasattr(p, "dim") and p.dim == last]
    parts = math.prod(mesh.size(i) for i in on)
    if on and heads % parts:
        x = x.redistribute(mesh, tuple(
            Replicate() if i in on else p
            for i, p in enumerate(x.placements)))
    return x.reshape(*x.shape[:-1], heads, d_head)


def take_pairs(z: torch.Tensor, i: torch.Tensor,
               j: torch.Tensor) -> torch.Tensor:
    """``z[:, i, j]`` of a DTensor ``z``, on each rank's local block laid
    out by its batch dim alone (DTensor's rule for the index's backward
    fails on some versions of torch)."""
    places = tuple(p if hasattr(p, "dim") and p.dim == 0 else Replicate()
                   for p in z.placements)
    if tuple(z.placements) != places:
        z = z.redistribute(z.device_mesh, places)
    local = z.to_local()[:, i, j]
    return DTensor.from_local(local, z.device_mesh, places, run_check=False,
                              shape=(z.shape[0], i.shape[0]),
                              stride=(i.shape[0], 1))


def block_of(x, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's block of ``x``'s dim ``dim``
    (a DTensor cut by ``Shard`` placements, in mesh-dim order)."""
    mesh = x.device_mesh
    block, parts = 0, 1
    for i, p in enumerate(x.placements):
        if hasattr(p, "dim") and p.dim == dim:
            if type(p).__name__ != "Shard":
                raise NotImplementedError(f"a block of {p}")
            block = block * mesh.size(i) + mesh.get_local_rank(i)
            parts *= mesh.size(i)
    n = x.shape[dim] // parts
    return block * n, n


def partial_over(x, dim: int) -> tuple:
    """Placements that are ``Partial`` where ``x`` shards ``dim`` and
    replicated elsewhere: the layout of a whole result each rank fills
    from its own block of that dim."""
    return tuple(Partial() if hasattr(p, "dim") and p.dim == dim
                 else Replicate() for p in x.placements)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole onto every device, as a plain tensor (no
    gradient flows through it)."""
    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim).to_local()


def flash_attention(q, k, v, window: int, causal: bool, chunk: int,
                   q_offset: int):
    """``models.common.flash_attention`` on DTensors, one rank's shard at
    a time:
    the batch over the FSDP axes and the query heads over ``model`` (as
    GSPMD partitions the reference's attention; dims they don't divide
    stay whole), keys and values gathered over ``model``.  Each rank runs
    :class:`_Flash` on its local query heads against the key / value
    heads of their groups (so the local head counts must nest: the local
    query heads a multiple of the group size or a divisor of it), and
    its output is that rank's shard.  The keys' and values' gradients
    come back as partial sums over ``model``."""

    q = C.shard_hint(q, "fsdp", None, "model", None)
    k = C.shard_hint(k, "fsdp", None, None, None)
    v = C.shard_hint(v, "fsdp", None, None, None)
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    rep = H // Hkv
    ql = q.to_local()
    hl = ql.shape[2]
    grad_kv = k.placements
    if hl != H:
        if hl % rep and rep % hl:
            raise ValueError(f"{hl} local query heads of groups of {rep} "
                             "do not nest")
        m = list(mesh.mesh_dim_names).index("model")
        c = mesh.get_local_rank(m)
        lo, hi = c * hl // rep, ((c + 1) * hl - 1) // rep + 1
        grad_kv = tuple(Partial() if i == m else p
                        for i, p in enumerate(k.placements))
    else:
        lo, hi = 0, Hkv
    kl = k.to_local(grad_placements=grad_kv)[:, :, lo:hi]
    vl = v.to_local(grad_placements=grad_kv)[:, :, lo:hi]
    ol = C._Flash.apply(ql, kl, vl, window, causal, chunk, q_offset)
    return DTensor.from_local(ol, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def logsumexp(x):
    """``logsumexp`` over the last dim of a DTensor, written as max,
    subtract, exp, sum, log, add so that each reduction over a sharded
    vocabulary is a partial one, all-reduced (DTensor has no sharded
    rule for ``logsumexp`` and would gather the logits whole)."""
    m = x.detach().amax(-1, keepdim=True)
    return (torch.log(torch.exp(x - m).sum(-1, keepdim=True))
            + m).squeeze(-1)


def take(x, idx):
    """``x.gather(-1, idx[..., None]).squeeze(-1)`` of a DTensor ``x``
    whose last dim (the vocabulary) may be sharded: each rank takes the
    ids that fall in its block of the last dim, 0 for the others, and the
    result is a partial sum over that mesh dim (the masked gather GSPMD
    makes of a ``take_along_axis`` on a sharded dim; DTensor's own rule
    for ``gather`` fails on 3-D masks).  ``idx`` is laid out as ``x``'s
    leading dims."""

    mesh = x.device_mesh
    last = x.ndim - 1
    on = [i for i, p in enumerate(x.placements)
          if p.is_shard() and p.dim == last]
    idx_places = tuple(p if p.is_shard() and i not in on else Replicate()
                       for i, p in enumerate(x.placements))
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    idx = idx.redistribute(mesh, idx_places)
    xl, il = x.to_local(), idx.to_local()
    n = xl.shape[-1]
    lo = 0
    for i in on:
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    li = il - lo * n
    hit = (li >= 0) & (li < n)
    g = torch.gather(xl, -1, li.clamp(0, n - 1)[..., None]).squeeze(-1)
    g = torch.where(hit, g, 0.0)
    return DTensor.from_local(
        g, mesh, tuple(Partial() if i in on or x.placements[i].is_partial()
                       else p for i, p in enumerate(idx_places)),
        run_check=False, shape=idx.shape, stride=idx.stride())


def moe_dispatch(hf, keep, slot, E: int, cap: int, K: int):
    """The dispatch scatter of DTensor tokens ``hf`` [N, D], each rank on
    its own: the tokens laid out over the fsdp axes, a rank adds its
    block's kept assignments (``keep``, ``slot``: replicated, [N·K]) into
    a whole [E, cap, D] buffer, and the buffer is a partial sum over
    those axes (GSPMD's partitioned scatter), which the dispatch hint
    reduce-scatters."""

    hf = C.shard_hint(hf, "fsdp", None)
    lo, n = block_of(hf, 0)
    hl = hf.to_local()
    a = slice(lo * K, (lo + n) * K)
    tok = torch.arange(n * K, device=hl.device) // K
    src = torch.where(keep[a, None], hl[tok], 0).to(hl.dtype)
    buf = torch.zeros((E * cap + 1, hl.shape[1]), dtype=hl.dtype,
                      device=hl.device)
    buf = buf.index_add(0, slot[a], src)[:E * cap].reshape(E, cap, -1)
    return DTensor.from_local(
        buf, hf.device_mesh, partial_over(hf, 0), run_check=False,
        shape=(E, cap, hf.shape[1]), stride=buf.stride())


def moe_combine(out, keep, slot):
    """``where(keep, out.reshape(E·cap, D)[slot], 0)`` of a DTensor
    ``out`` [E, cap, D] whose experts and capacity may be sharded: each
    rank takes the assignments whose slot falls in its block, 0 for the
    others, and the [N·K, D] result is a partial sum over those mesh dims
    (the masked gather GSPMD makes of a gather from a sharded operand),
    which the combine's hints reduce."""

    E, cap, D = out.shape
    (e0, ne), (c0, nc) = block_of(out, 0), block_of(out, 1)
    ol = out.to_local().reshape(ne * nc, D)
    e, c = slot // cap, slot % cap
    mine = keep & (e >= e0) & (e < e0 + ne) & (c >= c0) & (c < c0 + nc)
    li = ((e - e0) * nc + (c - c0)).clamp(0, ne * nc - 1)
    y = torch.where(mine[:, None], ol[li], 0)
    places = tuple(a if a.is_partial() else b for a, b in
                   zip(partial_over(out, 0), partial_over(out, 1)))
    return DTensor.from_local(y, out.device_mesh, places, run_check=False,
                              shape=(slot.shape[0], D), stride=(D, 1))
