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

The elementwise functions follow the reference op for op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.segment_coo.ops import pack_blocks, segment_sum_coo
from repro_torch.kernels.segment_coo.ref import segment_max
from repro_torch.models.common import ParamSpec, relu

#: Row-block height of the plans (the reference's ``segment_sum_coo``
#: default).
R_BLK = 8


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """One segment array packed for the kernel: ``n`` output rows,
    ``n_entries`` entries, row blocks of ``r_blk`` rows, ``n_live`` live
    slots (known at packing: the kernel formula's figure)."""
    edge_perm: torch.Tensor   # [n_blocks, E_BLK] i32 entry ids
    lrow: torch.Tensor        # [n_blocks, E_BLK] i32 local rows (r_blk: pad)
    gather: torch.Tensor      # [n_entries] i64: the entry's row, n if dead
    n: int
    n_entries: int
    n_live: int
    r_blk: int = R_BLK


def host_view(batch: Dict[str, Any]) -> Dict[str, Any]:
    """``batch`` with its host copies (``batch["host"]``, CPU tensors) in
    place of the tensors they copy: what the plans are packed from."""
    host = batch.get("host")
    return {**batch, **host} if host else batch


def scatter_plan(seg: torch.Tensor, n: int,
                 live: Optional[torch.Tensor] = None, *,
                 r_blk: int = R_BLK,
                 device: Optional[torch.device] = None) -> ScatterPlan:
    """Pack the live entries of ``seg`` (``0 <= seg < n`` and ``live``)
    on the host; the plan's tensors go to ``device`` (default ``seg``'s;
    a meta device takes their shapes)."""
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
    return ScatterPlan(
        edge_perm=torch.from_numpy(perm.astype(np.int32)).to(dev),
        lrow=torch.from_numpy(lrow).to(dev),
        gather=torch.from_numpy(np.where(keep, s, n)).to(dev),
        n=n, n_entries=int(s.shape[0]), n_live=int(ids.size), r_blk=r_blk)


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
    only the plan's live entries add."""
    if vals.shape[0] != plan.n_entries:
        raise ValueError(f"{vals.shape[0]} entries, the plan has "
                         f"{plan.n_entries}")
    return _ScatterSum.apply(vals, plan)


def scatter_mean(vals: torch.Tensor, plan: ScatterPlan,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    ones = torch.ones(vals.shape[:1], dtype=vals.dtype, device=vals.device)
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
    return torch.stack(feats, dim=-1)
