"""GNN substrate: masked message passing over padded edge lists.

The port of ``repro/models/gnn/common.py``.  Message passing is
``gather → segment sum → update`` over an edge-index array, with a
sentinel node ``n`` whose row absorbs the padding.  The reference sums by
``jax.ops.segment_sum``; here :func:`scatter_sum` sums through
``kernels.segment_coo.ops.segment_sum_coo`` (the hand-written
``segment_sum`` kernel on CUDA tensors, its plain version on CPU tensors)
on a :class:`ScatterPlan`, and its backward is the gather ``grad[seg]``
(plain torch: the reference has no kernel for it either).

A plan packs one segment array into the kernel's blocked layout on the
host (``pack_blocks``).  A model builds one a forward for each distinct
segment array and hands it to every scatter over that array.  It packs
only the *live* entries: those whose segment is ``< n`` and that the
caller's ``live`` mask keeps.  That is exact: the sentinel row is sliced
away, and a masked entry's payload is 0.  It also keeps the padding, which
sits on one row (the sentinel, or DimeNet's clamped ``E - 1``), out of the
row blocks, where it would set a block's slot count.

A batch may carry host copies of its index arrays under ``"host"``
(:func:`host_view`): the dry-run's abstract count hands the model meta
tensors, whose data the host cannot pack, and the copies they were made
from.  The plans are then packed from the copies and go to the batch's
device, meta included; without copies they are packed from the batch's
own tensors, as always.

On a mesh (the dry-run's sharded count, and the CPU check of its rules)
node arrays lie over the fsdp axes and edge arrays over fsdp + ``model``,
as the reference's ``gnn_build`` lays them out, and the batch's host
copies are this rank's slices of the index arrays (global ids).  The
message passing's ops take DTensors here, each rule beside its op:
:func:`gather_rows` (a node or edge table all-gathered, then indexed by
this rank's ids), :func:`scatter_sum` (this rank's entries summed into
every row by the op on its own plan, a ``Partial`` sum redistributed to
the plan's output layout) and :func:`scatter_amax` (a ``Partial("max")``,
all-reduced); :func:`linear` and :func:`expand_rows` keep edge arrays on
the edges' layout, and :func:`whole` gathers a table a loop of chunks
reads.  The reference's docstring calls these cross-shard gathers
and sums the halo exchange of the paper, implicit in GSPMD's collectives.

The elementwise functions follow the reference op for op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import is_dtensor
from repro_torch.kernels import note_read
from repro_torch.kernels.segment_coo.ops import pack_blocks, segment_sum_coo
from repro_torch.kernels.segment_coo.ref import segment_max
from repro_torch.models import common as MC
from repro_torch.models.common import ParamSpec, relu

#: Row-block height of the plans (the reference's ``segment_sum_coo``
#: default).
R_BLK = 8


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """One segment array packed for the kernel: ``n`` output rows,
    ``n_entries`` entries, row blocks of ``r_blk`` rows, ``n_live`` live
    slots (known at packing: the kernel formula's figure).

    On a mesh (``mesh`` set) the plan is this rank's: packed from its
    slice of the segment array, its entries laid out by ``places`` (the
    array's placements), and the sum laid out by ``out_places`` (one
    placement a mesh dim, for the output's rows)."""
    edge_perm: torch.Tensor   # [n_blocks, E_BLK] i32 entry ids
    lrow: torch.Tensor        # [n_blocks, E_BLK] i32 local rows (r_blk: pad)
    gather: torch.Tensor      # [n_entries] i64: the entry's row, n if dead
    n: int
    n_entries: int
    n_live: int
    r_blk: int = R_BLK
    mesh: Any = None
    places: tuple = ()
    out_places: tuple = ()


class Layout(NamedTuple):
    """How a DTensor lies on its mesh, without the tensor (a plan packed
    for an array that the forward lays out later: equiformer's edge
    chunks)."""
    device_mesh: Any
    placements: tuple


def host_view(batch: Dict[str, Any]) -> Dict[str, Any]:
    """``batch`` with its host copies (``batch["host"]``, CPU tensors) in
    place of the tensors they copy: what the plans are packed from."""
    host = batch.get("host")
    return {**batch, **host} if host else batch


def scatter_plan(seg: torch.Tensor, n: int,
                 live: Optional[torch.Tensor] = None, *,
                 r_blk: int = R_BLK,
                 device: Optional[torch.device] = None,
                 like: Any = None, rows: tuple = ()) -> ScatterPlan:
    """Pack the live entries of ``seg`` (``0 <= seg < n`` and ``live``)
    on the host; the plan's tensors go to ``device`` (default ``seg``'s;
    a meta device takes their shapes).

    ``like``, a DTensor (or its :class:`Layout`), makes the plan a rank's
    on its mesh: ``seg`` is this rank's slice of ``like`` (the segment
    array as the model holds it) and the entries are laid out as ``like``
    by its leading dim;
    ``rows``, the reference's spec of the output's rows (``("fsdp",)``:
    over the fsdp axes; ``()``: replicated), sets the sum's layout."""
    s = seg.detach().cpu().numpy().astype(np.int64)
    keep = (s >= 0) & (s < n)
    if live is not None:
        keep &= live.detach().cpu().numpy().astype(bool)
    ids = np.flatnonzero(keep)
    if ids.size:
        perm, lrow, _ = pack_blocks(s[ids], n, r_blk=r_blk)
        perm = ids[perm]
    else:  # nothing live: one padding slot a block
        n_blocks = (n + r_blk - 1) // r_blk
        perm = np.zeros((n_blocks, 1), np.int64)
        lrow = np.full((n_blocks, 1), r_blk, np.int32)
    dev = seg.device if device is None else device
    layout = {}
    if is_dtensor(like) or isinstance(like, Layout):
        from torch.distributed.tensor import Replicate, Shard

        if is_dtensor(like):
            note_read(like.to_local())
        mesh = like.device_mesh
        spec = tuple(MC.fsdp_axes(mesh) if r == "fsdp" else r for r in rows)
        layout = dict(
            mesh=mesh, out_places=MC.placements((n,), spec, mesh),
            places=tuple(Shard(0) if p.is_shard(0) else Replicate()
                         for p in like.placements))
    return ScatterPlan(
        edge_perm=torch.from_numpy(perm.astype(np.int32)).to(dev),
        lrow=torch.from_numpy(lrow).to(dev),
        gather=torch.from_numpy(np.where(keep, s, n)).to(dev),
        n=n, n_entries=int(s.shape[0]), n_live=int(ids.size), r_blk=r_blk,
        **layout)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, plan):
        ctx.plan, ctx.shape = plan, vals.shape
        flat = vals.reshape(plan.n_entries, -1).contiguous()
        out = segment_sum_coo(flat, plan.edge_perm, plan.lrow, plan.n,
                              r_blk=plan.r_blk, n_live=plan.n_live)
        return out.reshape((plan.n,) + vals.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        g = grad.reshape(plan.n, -1)
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])   # the dead row
        return g[plan.gather].reshape(ctx.shape), None


def scatter_sum(vals: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """segment-sum with one sentinel row absorbed: [E, ...] → [n, ...];
    only the plan's live entries add.  A plan on a mesh takes
    :func:`_sharded_scatter_sum`."""
    if plan.mesh is not None:
        return _sharded_scatter_sum(vals, plan)
    if vals.shape[0] != plan.n_entries:
        raise ValueError(f"{vals.shape[0]} entries, the plan has "
                         f"{plan.n_entries}")
    return _ScatterSum.apply(vals, plan)


def _as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh`` (a plain tensor: replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _partial_over(places, kind: str = "sum") -> tuple:
    """``Partial(kind)`` where ``places`` shard, replicated elsewhere:
    the layout of a result each rank fills from its own entries."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial(kind) if p.is_shard() else Replicate()
                 for p in places)


def _dtensor(local, mesh, places, shape):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, tuple(places), run_check=False,
                              shape=torch.Size(shape),
                              stride=MC.contiguous_strides(shape))


class _Reduce(torch.autograd.Function):
    """A rank's partial result (``local``, a ``Partial`` sum over the mesh
    dims ``partial`` marks) reduced to ``places``.  Its backward takes
    the cotangent whole, each rank's share of a sum being the whole
    cotangent; it does not go through DTensor's backward of a
    redistribution out of a ``Partial``, which some torch versions
    cannot take from a cotangent sharded on another dim."""

    @staticmethod
    def forward(ctx, local, mesh, partial, places, shape):
        ctx.mesh = mesh
        return _dtensor(local, mesh, partial, shape).redistribute(mesh,
                                                                  places)

    @staticmethod
    def backward(ctx, grad):
        return whole(grad).to_local(), None, None, None, None


def _sharded_scatter_sum(vals, plan: ScatterPlan):
    """The rule of :func:`scatter_sum` on a mesh: ``vals`` laid out as the
    plan's entries (``plan.places``), each rank sums its own entries into
    all ``n`` rows by the op on its own plan (the ``segment_sum`` kernel,
    counted on the local plan), and the ``Partial`` sum over the axes
    that cut the entries is redistributed to ``plan.out_places`` (a
    reduce-scatter onto node rows, or an all-reduce).  The backward
    gathers the cotangent whole and takes each local entry's row, as
    :func:`gather_rows` does."""
    mesh = plan.mesh
    v = _as_dtensor(vals, mesh)
    if tuple(v.placements) != plan.places:
        v = v.redistribute(mesh, plan.places)
    local = v.to_local()
    if local.shape[0] != plan.n_entries:
        raise ValueError(f"{local.shape[0]} local entries, the plan has "
                         f"{plan.n_entries}")
    return _Reduce.apply(_ScatterSum.apply(local, plan), mesh,
                         _partial_over(plan.places), plan.out_places,
                         (plan.n,) + tuple(v.shape[1:]))


def pad_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one row of zeros below (the sentinel row the padding ids
    name).  A DTensor is gathered whole first (the halo exchange) by a
    redistribution of its own, so its gradient comes back in its own
    layout (see :func:`_sharded_linear`)."""
    if is_dtensor(x):
        x = whole(x)
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` indexed by ``idx`` (a plain tensor) along ``dim``:
    ``x[:, ..., idx]``.  A DTensor is indexed on each rank's block (``dim``
    and any partial sum gathered first), forward and backward local:
    DTensor's own rules for the index and its backward fail or misplace
    the blocks on some torch versions."""
    at = (slice(None),) * dim + (idx,)
    if not is_dtensor(x):
        return x[at]
    from torch.distributed.tensor import Replicate

    places = tuple(Replicate() if p.is_partial() or p.is_shard(dim) else p
                   for p in x.placements)
    if tuple(x.placements) != places:
        x = x.redistribute(x.device_mesh, places)
    shape = list(x.shape)
    shape[dim] = idx.shape[0]
    return _dtensor(x.to_local()[at], x.device_mesh, places, shape)


def repeat_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    """``torch.repeat_interleave(x, k, dim=1)``; a DTensor by
    :func:`take`."""
    if not is_dtensor(x):
        return torch.repeat_interleave(x, k, dim=1)
    cols = torch.arange(x.shape[1], device=x.to_local().device)
    return take(x, torch.repeat_interleave(cols, k), 1)


def whole(table: torch.Tensor) -> torch.Tensor:
    """``table`` whole on every rank: a DTensor all-gathered (its gradient
    reduce-scattered back), so that the gathers of a loop over edge
    chunks move nothing more; a plain tensor as it is."""
    if not is_dtensor(table):
        return table
    from torch.distributed.tensor import Replicate

    places = (Replicate(),) * table.device_mesh.ndim
    if tuple(table.placements) == places:
        return table
    return table.redistribute(table.device_mesh, places)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: rows of a node or edge table by ids (in range).
    DTensors take :func:`_sharded_gather_rows`."""
    if is_dtensor(table) or is_dtensor(idx):
        return _sharded_gather_rows(table, idx)
    return table[idx]


def _sharded_gather_rows(table, idx):
    """The rule of :func:`gather_rows` on a mesh: the table all-gathered
    over the axes that shard it (the halo exchange), each rank indexing
    it with its own ids; the rows are laid out as the ids.  The table's
    gradient is each rank's scatter of its rows' cotangents, a
    ``Partial`` sum over the axes that shard the ids, which the gather's
    backward reduce-scatters to the table's layout."""
    mesh = (table if is_dtensor(table) else idx).device_mesh
    idx, table = _as_dtensor(idx, mesh), whole(_as_dtensor(table, mesh))
    local = table.to_local(grad_placements=_partial_over(idx.placements))
    rows = local[idx.to_local()]
    return _dtensor(rows, mesh, idx.placements,
                    tuple(idx.shape) + tuple(table.shape[1:]))


def expand_rows(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``w`` [1, d] broadcast to one row for each of ``like``'s (a view).
    On a mesh the rows are laid out as ``like``'s: each rank broadcasts
    to its own rows, and ``w``'s gradient is a ``Partial`` sum over the
    axes that cut them."""
    if not (is_dtensor(w) or is_dtensor(like)):
        return w.expand(like.shape[0], w.shape[1])
    from torch.distributed.tensor import Replicate

    mesh = (like if is_dtensor(like) else w).device_mesh
    like, w = _as_dtensor(like, mesh), whole(_as_dtensor(w, mesh))
    places = tuple(p if p.is_shard(0) else Replicate()
                   for p in like.placements)
    local = w.to_local(grad_placements=_partial_over(places))
    rows = local.expand(like.to_local().shape[0], w.shape[1])
    return _dtensor(rows, mesh, places, (like.shape[0], w.shape[1]))


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: rows of activations (edges or nodes) by a weight.
    DTensors take :func:`_sharded_linear`."""
    if is_dtensor(x) or is_dtensor(w):
        return _sharded_linear(x, w)
    return x @ w


def _sharded_linear(x, w):
    """The rule of :func:`linear` on a mesh, as GSPMD partitions the
    reference's product around its weight's spec: the weight keeps its
    shards; where a mesh axis that shards the weight also cuts the rows
    of ``x`` (edges over fsdp + ``model`` against a weight over
    ``model``), ``x`` is all-gathered over that axis, and where it cuts
    the weight's output features, ``x``'s features are gathered; a
    partial ``x`` is reduced.  ``x`` is laid out so by a redistribution
    of its own, so that its gradient comes back in its own layout (an
    activation used twice then sums two gradients laid out alike: some
    torch versions cannot add a ``Partial`` gradient to a sharded one);
    DTensor's rule for the product does the rest."""
    from torch.distributed.tensor import Replicate

    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    last = x.ndim - 1

    def laid(p, q):
        if p.is_partial():
            return Replicate()
        if q.is_shard() and p.is_shard() and (p.dim < last or q.dim == 1):
            return Replicate()
        return p

    places = tuple(laid(p, q) for p, q in zip(x.placements, w.placements))
    if tuple(x.placements) != places:
        x = x.redistribute(mesh, places)
    return x @ w


def scatter_amax(acc: torch.Tensor, seg: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``acc.scatter_reduce(0, seg, vals, "amax", include_self=True)``
    with ``seg`` [E] and ``vals`` [E, H]: each row's running max.
    DTensors take :func:`_sharded_scatter_amax`."""
    if is_dtensor(acc) or is_dtensor(seg) or is_dtensor(vals):
        return _sharded_scatter_amax(acc, seg, vals)
    return acc.scatter_reduce(0, seg[:, None].expand(-1, vals.shape[1]),
                              vals, "amax", include_self=True)


def _sharded_scatter_amax(acc, seg, vals):
    """The rule of :func:`scatter_amax` on a mesh: ``vals`` laid out as
    ``seg``, ``acc`` whole; each rank takes the max of ``acc`` and its own
    entries, a ``Partial("max")`` over the axes that shard the entries,
    which an all-reduce (max) makes whole.  The gradient goes where the
    op's would: to the entries, or to ``acc``, that hold a row's max (on
    the ranks whose local max is the whole max)."""
    from torch.distributed.tensor import Replicate

    mesh = next(x for x in (acc, seg, vals) if is_dtensor(x)).device_mesh
    seg = _as_dtensor(seg, mesh)
    places = tuple(p if p.is_shard(0) else Replicate()
                   for p in seg.placements)
    vals, acc = _as_dtensor(vals, mesh), whole(_as_dtensor(acc, mesh))
    if tuple(seg.placements) != places:
        seg = seg.redistribute(mesh, places)
    if tuple(vals.placements) != places:
        vals = vals.redistribute(mesh, places)
    sl, vl = seg.to_local(), vals.to_local()
    mine = acc.to_local().scatter_reduce(
        0, sl[:, None].expand(-1, vl.shape[1]), vl, "amax",
        include_self=True)
    top = whole(_dtensor(mine.detach(), mesh, _partial_over(places, "max"),
                         tuple(acc.shape))).to_local()
    return _dtensor(torch.where(mine == top, mine, top), mesh,
                    acc.placements, tuple(acc.shape))


def scatter_mean(vals: torch.Tensor, plan: ScatterPlan,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if is_dtensor(vals):     # laid out as the entries
        ones = torch.ones_like(vals[:, 0] if vals.dim() > 1 else vals)
    else:
        ones = torch.ones(vals.shape[:1], dtype=vals.dtype,
                          device=vals.device)
    if mask is not None:
        vals = torch.where(mask[:, None], vals, 0) if vals.dim() > 1 else \
            torch.where(mask, vals, 0)
        ones = torch.where(mask, ones, 0)
    s = scatter_sum(vals, plan)
    c = scatter_sum(ones, plan)
    return s / torch.clamp(c[:, None] if s.dim() > 1 else c, min=1e-9)


def scatter_max(vals: torch.Tensor, seg: torch.Tensor, n: int
                ) -> torch.Tensor:
    """``scatter_reduce(amax)``; empty rows hold -inf, as
    ``jax.ops.segment_max``.  No kernel: no model calls it."""
    return segment_max(vals, seg.long(), n + 1)[:n]


def mlp_specs(dims, prefix: str = "") -> Dict[str, Any]:
    specs = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"{prefix}w{i}"] = ParamSpec((a, b), torch.float32)
        specs[f"{prefix}b{i}"] = ParamSpec((b,), torch.float32, init="zeros")
    return specs


def mlp_apply(params, x: torch.Tensor, n_layers: int, act=relu,
              prefix: str = "", final_act: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ getattr(params, f"{prefix}w{i}") \
            + getattr(params, f"{prefix}b{i}")
        if i < n_layers - 1 or final_act:
            x = act(x)
    return x


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def node_xent_loss(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    if is_dtensor(logits):   # the LM loss's rules (a sharded class dim)
        rules = MC.sharded_rules()
        lse, gold = rules.logsumexp(logits), rules.take(logits,
                                                        labels.long())
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[:, None].long(),
                                    dim=-1).squeeze(1)
    per = (lse - gold) * mask
    return per.sum() / torch.clamp(mask.sum(), min=1.0)


def radial_basis(dist: torch.Tensor, n_radial: int,
                 cutoff: float = 5.0) -> torch.Tensor:
    """DimeNet's spherical-Bessel-flavoured radial basis (sin(nπd/c)/d)."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=dist.device)
    d = torch.clamp(dist[..., None], min=1e-6)
    env = _envelope(dist / cutoff)[..., None]
    return env * math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d
                                                     / cutoff) / d


def _envelope(x: torch.Tensor, p: int = 6) -> torch.Tensor:
    """Smooth cutoff envelope (DimeNet eq. 8)."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    e = 1.0 / torch.clamp(x, min=1e-6) + a * x ** (p - 1) + b * x ** p \
        + c * x ** (p + 1)
    return torch.where(x < 1.0, e, 0.0)


def angular_basis(angle: torch.Tensor, n_spherical: int) -> torch.Tensor:
    """cos(k·θ) Chebyshev-flavoured angular basis (SBF stand-in)."""
    k = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    return torch.cos(k * angle[..., None])


def spherical_harmonics_dirs(dirs: torch.Tensor, l_max: int) -> torch.Tensor:
    """Real SH-flavoured direction features up to l_max: [E, (l_max+1)^2],
    by the associated-Legendre recursion on cosθ with cos/sin(mφ) factors
    (unnormalised; a per-l learned scale in the model absorbs it)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cos_t = z
    phi = torch.atan2(y, x)
    P = {(0, 0): torch.ones_like(cos_t)}
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * sin_t * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * cos_t * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * cos_t * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    feats = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            if m < 0:
                feats.append(P[(l, -m)] * torch.sin(-m * phi))
            elif m == 0:
                feats.append(P[(l, 0)])
            else:
                feats.append(P[(l, m)] * torch.cos(m * phi))
    # the last dim by its index: some torch versions misplace a DTensor
    # stacked at dim -1
    return torch.stack(feats, dim=feats[0].dim())
