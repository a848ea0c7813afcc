"""Aggregate engine — one pluggable backend for every segment reduction.

Port of :mod:`repro.core.engine` (whose docstring gives the design: rules
*declare* the :class:`~repro_torch.core.rules.SweepCtx` aggregates their
tests need, named schedules order the rule families and pick the refresh
granularity, and :func:`aggregate` is the single entry point for segment
reductions over the static edge list).

Backends of :func:`aggregate`:

  * ``"torch"``   — scatter ops on the COO edge list (``index_add_`` /
    ``scatter_reduce_`` with identity-initialised outputs, OR by bitplanes);
    the counterpart of the reference's ``jnp`` backend,
  * ``"blocked"`` — the blocked-ELL :class:`SegPlan` layout through the
    plain torch per-block reduction (gather, then reduce),
  * ``"cuda"``    — the same layout through the hand-written CUDA kernel
    (``kernels/segment_coo``), one pass over the packed edge blocks for all
    sum+max+min+bitwise-OR payloads, the payload gather inside the kernel;
    the counterpart of the reference's ``pallas`` backend.  On CPU tensors
    it takes the kernel's plain version.

All payloads are int32 and integer addition is associative, so every
backend is bit-identical: backend choice is purely a performance decision.
On the blocked backends the capped-window activity bits and the clique
test ride the same edge pass as OR payloads (static per-edge ``wbits`` /
``wnh`` in the plan); the torch backend computes them from the [V, D]
window layout.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import rules as R
from repro_torch.kernels.segment_coo.ops import (
    pack_blocks, segment_fused_coo, segment_fused_plain,
)
from repro_torch.kernels.segment_coo.ref import (
    live_extent, segment_max, segment_min, segment_or_ref, segment_sum,
)
from repro_torch.kernels.wedge_intersect import ops as W

I32 = torch.int32
I32_MIN = torch.iinfo(torch.int32).min

#: Aggregate backends (see module docstring).
BACKENDS = ("torch", "blocked", "cuda")

#: Default row-block height of the blocked-ELL packing.
R_BLK = 8

#: Candidate row-block heights for plan-build-time autotuning.
R_BLK_CANDIDATES = (8, 16, 32, 64)

#: Edge-budget alignment of the packing (kept from the reference so both
#: packings, and so both plans' sizes, agree).
E_BLK_MULTIPLE = 8

#: Rule registry: schedule entries name rules; order comes from Schedule.
RULES = {
    "degree_one": R.rule_degree_one,
    "neighborhood_removal": R.rule_neighborhood_removal,
    "weight_transfer": R.rule_weight_transfer,
    "simplicial": R.rule_simplicial,
    "basic_single_edge": R.rule_basic_single_edge,
    "extended_single_edge": R.rule_extended_single_edge,
}


class Schedule(NamedTuple):
    """A rule schedule: which families run, in what order, and how often
    their test aggregates are refreshed ("rule" | "sweep")."""

    rules: Tuple[str, ...]
    refresh: str


#: The paper's §5.1 cheap-family order.
CHEAP_ORDER = (
    "degree_one",
    "neighborhood_removal",
    "weight_transfer",
    "simplicial",
    "basic_single_edge",
    "extended_single_edge",
)

#: Named schedules consumed by DisReduConfig.schedule.
SCHEDULES = {
    # per-rule semantics: every family sees fresh aggregates
    "cheap": Schedule(CHEAP_ORDER, "rule"),
    # fused hot path: aggregates snapshotted once per sweep
    "cheap-fused": Schedule(CHEAP_ORDER, "sweep"),
    # degree + neighborhood sums only, no window/clique machinery
    "light": Schedule(("degree_one", "neighborhood_removal"), "sweep"),
    # everything except the capped-window clique rules
    "edges-only": Schedule(
        ("degree_one", "neighborhood_removal", "basic_single_edge",
         "extended_single_edge"),
        "sweep",
    ),
}


def schedule_requires(schedule: Schedule) -> frozenset:
    """Union of the scheduled rules' aggregate declarations."""
    req = frozenset()
    for name in schedule.rules:
        req |= RULES[name].requires
    return req


# --------------------------------------------------------------------- #
# blocked-ELL plans (host-side packing of the static edge list)
# --------------------------------------------------------------------- #
class SegPlan(NamedTuple):
    """Precomputed blocked-ELL packing of one (static) row array.

    ``wbits`` / ``wnh`` are the static per-edge window-position payloads
    that let the fused pass emit act_bits/clique (None when the plan was
    built without window structure).

    A *stacked* plan (:func:`stack_plans`) carries B same-shape plans on a
    leading axis — ``edge_perm`` / ``lrow`` ``[B, n_blocks, E_BLK]`` with
    per-instance edge ids — and its ``wbits`` / ``wnh`` are the instances'
    payloads one after another, ``[B*E]``: the union edge order of a
    stacked problem (``distributed.stack_problems``).

    ``extent`` is derived from ``lrow`` (:func:`live_extent`): one past
    each row block's last live slot, so the kernel reads none of the
    padding after it.  ``edge_perm`` / ``lrow`` stay the reference's
    arrays."""

    edge_perm: torch.Tensor   # [(B,) n_blocks, E_BLK] i32
    lrow: torch.Tensor        # [(B,) n_blocks, E_BLK] i32 (r_blk = padding)
    r_blk: int                # row-block height
    extent: torch.Tensor      # [(B,) n_blocks] i32 live extents
    wbits: Optional[torch.Tensor] = None  # [(B*)E] i32 window-position bits
    wnh: Optional[torch.Tensor] = None    # [(B*)E] i32 clique-violation masks


def autotune_r_blk(
    row: np.ndarray, n_rows: int,
    candidates: Tuple[int, ...] = R_BLK_CANDIDATES,
) -> int:
    """Pick the row-block height minimizing padded blocked-ELL slots.

    The edge budget E_BLK is the max edge count over row blocks, so skewed
    degree distributions blow up the padding at small R_BLK; larger blocks
    average the skew out.  Cost = total padded slots (n_blocks * E_BLK),
    ties broken toward the smaller R_BLK."""
    rows = np.asarray(row)
    if rows.ndim == 1:
        rows = rows[None, :]
    best_r, best_cost = candidates[0], None
    for r in candidates:
        n_blocks = max((n_rows + r - 1) // r, 1)
        e_blk = max(
            int(np.bincount(rows[i] // r, minlength=n_blocks)
                .max(initial=1))
            for i in range(rows.shape[0])
        )
        e_blk = ((max(e_blk, 1) + E_BLK_MULTIPLE - 1) // E_BLK_MULTIPLE) \
            * E_BLK_MULTIPLE
        cost = n_blocks * e_blk
        if best_cost is None or cost < best_cost:
            best_r, best_cost = r, cost
    return best_r


def _window_payloads(
    row: np.ndarray, col: np.ndarray, gid: np.ndarray,
    window: np.ndarray, win_adj_bits: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-edge window payloads (host-side, once per partition).

    For edge (v, u): ``wbits`` ORs ``1 << i`` over every window position i
    of v holding u; ``wnh`` ORs the matching clique-violation masks
    ``~(win_adj_bits[v, i] | 1 << i)`` truncated to D bits.  Window entries
    are edge targets by construction, so the OR over a vertex's edges
    recovers exactly the window loop."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    D = window.shape[1]
    if D >= 32:
        raise ValueError(f"window cap D={D} must fit int32 OR payloads")
    mask_d = np.int32((1 << D) - 1)
    ent = np.asarray(window, np.int64)[row]          # [E, D]
    adj = np.asarray(win_adj_bits, np.int32)[row]    # [E, D]
    gok = np.asarray(gid, np.int32)[col] >= 0
    wbits = np.zeros(row.shape[0], np.int32)
    wnh = np.zeros(row.shape[0], np.int32)
    for i in range(D):
        m = (ent[:, i] == col) & gok
        wbits |= m.astype(np.int32) << i
        wnh |= np.where(m, ~(adj[:, i] | np.int32(1 << i)) & mask_d, 0)
    return wbits, wnh


def build_plan(
    row: np.ndarray, n_rows: int, *, r_blk: Optional[int] = R_BLK,
    col: Optional[np.ndarray] = None, gid: Optional[np.ndarray] = None,
    window: Optional[np.ndarray] = None,
    win_adj_bits: Optional[np.ndarray] = None,
    device: torch.device | str = "cpu",
) -> SegPlan:
    """Pack one row array into a blocked-ELL plan on ``device``.

    ``r_blk=None`` autotunes the row-block height (:func:`autotune_r_blk`).
    Passing the static window structure (col/gid/window/win_adj_bits) also
    packs the act_bits/clique payloads for the fused pass."""
    if r_blk is None:
        r_blk = autotune_r_blk(np.asarray(row), n_rows)
    perm, lrow, _ = pack_blocks(
        np.asarray(row), n_rows, r_blk=r_blk, e_blk_multiple=E_BLK_MULTIPLE
    )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    wbits = wnh = None
    if window is not None:
        wb, wn = _window_payloads(row, col, gid, window, win_adj_bits)
        wbits, wnh = dev(wb), dev(wn)
    lrow = dev(lrow)
    return SegPlan(edge_perm=dev(perm), lrow=lrow, r_blk=r_blk,
                   wbits=wbits, wnh=wnh, extent=live_extent(lrow, r_blk))


# --------------------------------------------------------------------- #
# topology-keyed plan caching (the serving layer's reuse contract)
# --------------------------------------------------------------------- #
def topology_hash(row: np.ndarray, col: np.ndarray, n_rows: int) -> str:
    """Digest of the (sorted) directed edge list — weights excluded.

    Two instances share a hash iff they have the same vertex budget and the
    same edge set, which is exactly when every topology-derived artifact
    (blocked-ELL :class:`SegPlan`, window payloads, halo routing) is
    reusable verbatim; only the weight vector differs between requests.
    The pairs are lexsorted first, so any permutation of the same edge
    multiset maps to one key."""
    row = np.ascontiguousarray(row, dtype=np.int64).reshape(-1)
    col = np.ascontiguousarray(col, dtype=np.int64).reshape(-1)
    order = np.lexsort((col, row))
    h = hashlib.sha1()
    h.update(np.int64(n_rows).tobytes())
    h.update(row[order].tobytes())
    h.update(col[order].tobytes())
    return h.hexdigest()


class PlanCacheStats(NamedTuple):
    hits: int
    misses: int
    evictions: int
    size: int
    errors: int = 0          # build() raises observed by get_or_build
    descent_hits: int = 0    # tag="descent" lookups served from cache
    descent_misses: int = 0  # tag="descent" lookups that (re)built


class PlanCache:
    """Bounded LRU cache for topology-keyed artifacts (SegPlans, packed
    serve entries).  Host-side and not thread-safe — one cache per service
    or solver run.  ``max_entries`` bounds the resident entries; hits refresh
    recency.  The ``tag="descent"`` counters count the staged solver's
    re-packs (:func:`repro_torch.core.solvers.solve_staged`)."""

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError("PlanCache needs max_entries >= 1")
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()
        self._hits = self._misses = self._evictions = self._errors = 0
        self._descent_hits = self._descent_misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def get(self, key, tag: Optional[str] = None):
        """Value for ``key`` (refreshing recency) or None on a miss;
        ``tag="descent"`` also counts the lookup in the descent counters."""
        if key in self._d:
            self._d.move_to_end(key)
            self._hits += 1
            if tag == "descent":
                self._descent_hits += 1
            return self._d[key]
        self._misses += 1
        if tag == "descent":
            self._descent_misses += 1
        return None

    def put(self, key, value) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self._evictions += 1

    def get_or_build(self, key, build, tag: Optional[str] = None):
        """Cached value for ``key``, calling ``build()`` (and caching) on a
        miss.  A raising ``build()`` leaves the cache **unpoisoned**: no
        entry for ``key``, the miss counted once, the failure counted in
        ``stats.errors``, and the exception propagates."""
        val = self.get(key, tag=tag)
        if val is None:
            try:
                val = build()
            except Exception:
                self._errors += 1
                raise
            self.put(key, val)
        return val

    @property
    def stats(self) -> PlanCacheStats:
        return PlanCacheStats(
            hits=self._hits, misses=self._misses,
            evictions=self._evictions, size=len(self._d),
            errors=self._errors,
            descent_hits=self._descent_hits,
            descent_misses=self._descent_misses,
        )


def plan_for(
    cache: Optional[PlanCache],
    row: np.ndarray, n_rows: int, *, r_blk: Optional[int] = R_BLK,
    col: Optional[np.ndarray] = None, gid: Optional[np.ndarray] = None,
    window: Optional[np.ndarray] = None,
    win_adj_bits: Optional[np.ndarray] = None,
    tag: Optional[str] = None,
    device: torch.device | str = "cpu",
) -> SegPlan:
    """:func:`build_plan` through a :class:`PlanCache` keyed by topology
    hash (plus the static build knobs and the device).  ``cache=None``
    builds uncached."""
    def build():
        return build_plan(row, n_rows, r_blk=r_blk, col=col, gid=gid,
                          window=window, win_adj_bits=win_adj_bits,
                          device=device)

    if cache is None:
        return build()
    key = (
        topology_hash(row, col if col is not None else row, n_rows),
        r_blk, window is not None, str(device),
    )
    return cache.get_or_build(key, build, tag=tag)


# --------------------------------------------------------------------- #
# batched plans (serving layer: one pass over many stacked instances)
# --------------------------------------------------------------------- #
def pad_plan(plan: SegPlan, e_blk: int) -> SegPlan:
    """Pad a plan's edge budget up to ``e_blk`` so same-cell plans stack.

    Padding slots follow the :func:`pack_blocks` convention — edge 0 with
    ``lrow = r_blk`` — which every blocked path ignores, so a padded plan
    gives the original's results bit for bit.  They come after every live
    slot, so the live extents stay as they are."""
    nb, eb = plan.edge_perm.shape
    if eb > e_blk:
        raise ValueError(f"cannot shrink plan E_BLK {eb} -> {e_blk}")
    if eb == e_blk:
        return plan
    dev = plan.edge_perm.device
    perm = torch.zeros((nb, e_blk), dtype=I32, device=dev)
    perm[:, :eb] = plan.edge_perm
    lrow = torch.full((nb, e_blk), plan.r_blk, dtype=I32, device=dev)
    lrow[:, :eb] = plan.lrow
    return plan._replace(edge_perm=perm, lrow=lrow)


def stack_plans(plans: Sequence[SegPlan],
                e_blk: Optional[int] = None,
                batch_multiple: int = 1) -> SegPlan:
    """Stack same-cell plans onto a leading batch axis (shared E_BLK).

    All plans must share ``r_blk`` and row-block count (one serve cell);
    each is padded to the common edge budget — ``e_blk`` if given (the
    serving layer's high-water mark), else the batch's largest.  Window
    payloads must be present in all plans or in none, and are concatenated
    ``[B*E]`` (see :class:`SegPlan`).  ``batch_multiple`` pads the batch up
    to a multiple by repeating the LAST plan (phantom instances, as the
    serving layer repeats its last request)."""
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    if batch_multiple < 1:
        raise ValueError(f"batch_multiple must be >= 1, got {batch_multiple}")
    if len(plans) % batch_multiple:
        pad = batch_multiple - len(plans) % batch_multiple
        plans = list(plans) + [plans[-1]] * pad
    r_blk = plans[0].r_blk
    nb = plans[0].edge_perm.shape[0]
    if any(p.r_blk != r_blk or p.edge_perm.shape[0] != nb for p in plans):
        raise ValueError("stack_plans needs plans from one serve cell "
                         "(same r_blk and row-block count)")
    has_w = [p.wbits is not None for p in plans]
    if any(h != has_w[0] for h in has_w):
        raise ValueError("mixed window payloads across batch plans")
    if has_w[0] and len({p.wbits.shape[0] for p in plans}) != 1:
        raise ValueError("stack_plans needs one edge count across the batch")
    need = max(p.edge_perm.shape[1] for p in plans)
    if e_blk is None:
        e_blk = need
    elif e_blk < need:
        raise ValueError(f"e_blk={e_blk} below batch requirement {need}")
    padded = [pad_plan(p, e_blk) for p in plans]
    return SegPlan(
        edge_perm=torch.stack([p.edge_perm for p in padded]),
        lrow=torch.stack([p.lrow for p in padded]),
        r_blk=r_blk,
        wbits=torch.cat([p.wbits for p in padded]) if has_w[0] else None,
        wnh=torch.cat([p.wnh for p in padded]) if has_w[0] else None,
        extent=torch.stack([p.extent for p in padded]),
    )


# --------------------------------------------------------------------- #
# the one segment-reduction entry point (backend dispatch)
# --------------------------------------------------------------------- #
def aggregate(
    seg: Optional[torch.Tensor],
    n_rows: int,
    *,
    data_sum: Optional[torch.Tensor] = None,
    data_max: Optional[torch.Tensor] = None,
    data_min: Optional[torch.Tensor] = None,
    data_or: Optional[torch.Tensor] = None,
    or_nbits: int = 16,
    backend: str = "torch",
    plan: Optional[SegPlan] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Segment-reduce edge payloads to [n_rows] outputs on one backend.

    Returns a ``(sum, max, min, or)`` tuple (None for absent groups); 1-D
    payloads come back 1-D.  ``seg`` is the per-item segment id array,
    needed by the torch backend only (the blocked backends traverse the
    precomputed ``plan``).  A stacked plan (:func:`stack_plans`) of B
    instances reduces the union layout of a stacked problem: ``n_rows``
    rows, B blocks of ``n_rows / B``, each instance's own edges."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown aggregate backend {backend!r}")
    groups = [data_sum, data_max, data_min, data_or]
    if all(d is None for d in groups):
        raise ValueError("aggregate needs at least one payload group")

    squeeze = [d is not None and d.dim() == 1 for d in groups]
    groups = [d[:, None] if d is not None and d.dim() == 1 else d
              for d in groups]
    d_sum, d_max, d_min, d_or = groups

    if backend == "torch":
        if seg is None:
            raise ValueError("backend 'torch' needs the segment id array")
        outs = (
            segment_sum(d_sum, seg, n_rows) if d_sum is not None else None,
            segment_max(d_max, seg, n_rows) if d_max is not None else None,
            segment_min(d_min, seg, n_rows) if d_min is not None else None,
            segment_or_ref(d_or, seg, n_rows, nbits=or_nbits)
            if d_or is not None else None,
        )
    else:
        if plan is None:
            raise ValueError(f"backend {backend!r} needs a SegPlan")
        kw = dict(data_sum=d_sum, data_max=d_max, data_min=d_min,
                  data_or=d_or, or_nbits=or_nbits, r_blk=plan.r_blk)
        fused = segment_fused_plain
        if backend == "cuda":
            fused, kw["extent"] = segment_fused_coo, plan.extent
        rows = n_rows
        if plan.edge_perm.dim() == 3:
            batch = plan.edge_perm.shape[0]
            if n_rows % batch:
                raise ValueError(f"n_rows={n_rows} does not split into the "
                                 f"stacked plan's {batch} instances")
            rows = n_rows // batch
        outs = fused(plan.edge_perm, plan.lrow, rows, **kw)
    return tuple(
        o[:, 0] if o is not None and sq else o
        for o, sq in zip(outs, squeeze)
    )


def aggregate_batched(
    seg: Optional[torch.Tensor],
    n_rows: int,
    *,
    data_sum: Optional[torch.Tensor] = None,
    data_max: Optional[torch.Tensor] = None,
    data_min: Optional[torch.Tensor] = None,
    data_or: Optional[torch.Tensor] = None,
    or_nbits: int = 16,
    backend: str = "torch",
    plan: Optional[SegPlan] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """:func:`aggregate` over a leading batch axis.

    Payloads (and ``seg``, when given) carry a leading batch dimension
    ``[B, E, ...]``; the blocked backends need a stacked ``plan``
    (:func:`stack_plans`).  Every instance is reduced independently, in one
    pass over the union layout, and the outputs come back
    ``[B, n_rows, ...]`` — bit-identical per instance to the unbatched
    entry point on every backend (the payloads are int32)."""
    groups = (data_sum, data_max, data_min, data_or)
    first = next((d for d in groups if d is not None), None)
    if first is None:
        raise ValueError("aggregate needs at least one payload group")
    batch, n_edges = first.shape[:2]
    if backend != "torch" and (plan is None or plan.edge_perm.dim() != 3
                               or plan.edge_perm.shape[0] != batch):
        raise ValueError(f"backend {backend!r} needs a stacked SegPlan of "
                         f"{batch} instances (engine.stack_plans)")
    useg = None
    if seg is not None:
        off = torch.arange(batch, device=seg.device, dtype=seg.dtype)
        useg = (seg + off[:, None] * n_rows).reshape(-1)
    flat = [None if d is None else d.reshape((batch * n_edges,) + d.shape[2:])
            for d in groups]
    outs = aggregate(
        useg, batch * n_rows, data_sum=flat[0], data_max=flat[1],
        data_min=flat[2], data_or=flat[3], or_nbits=or_nbits,
        backend=backend, plan=plan,
    )
    return tuple(None if o is None else o.reshape((batch, n_rows)
                                                  + o.shape[1:])
                 for o in outs)


# --------------------------------------------------------------------- #
# aggregate computation (SweepCtx for the scheduled rules)
# --------------------------------------------------------------------- #
def ctx_payloads(
    state: R.RedState,
    aux: R.Aux,
    requires: frozenset,
    *,
    window_bits: bool,
    plan: Optional[SegPlan] = None,
):
    """The edge payloads of one fused pass for ``requires``.

    Returns ``(sum_fields, max_fields, data_sum, data_max, data_or)``: the
    SweepCtx fields carried by the [E, 2] sum and max groups (S/deg and
    M/only), and — with ``window_bits`` — the plan's static wbits/wnh OR
    payloads masked by the activity of each edge's target."""
    active = R._active(state)
    eact = R._edge_active(aux, active)
    edge_req = requires & {"S", "deg", "M", "only"}
    payload = {
        "S": lambda: torch.where(eact, R._aw(state, active)[aux.col], 0),
        "deg": lambda: eact.to(I32),
        "M": lambda: torch.where(eact, state.w[aux.col], I32_MIN),
        "only": lambda: torch.where(eact, aux.col, -1),
    }
    sum_fields = [f for f in ("S", "deg") if f in edge_req]
    max_fields = [f for f in ("M", "only") if f in edge_req]
    data_sum = (
        torch.stack([payload[f]() for f in sum_fields], dim=1)
        if sum_fields else None
    )
    data_max = (
        torch.stack([payload[f]() for f in max_fields], dim=1)
        if max_fields else None
    )
    data_or = None
    if window_bits and requires & {"act_bits", "clique"}:
        if plan is None or plan.wbits is None:
            raise ValueError(
                "plan lacks window payloads; build it with the window "
                "structure (col/gid/window/win_adj_bits) to compute "
                "act_bits/clique on the blocked backends"
            )
        data_or = torch.where(
            active[aux.col][:, None],
            torch.stack([plan.wbits, plan.wnh], dim=1), 0,
        )
    return sum_fields, max_fields, data_sum, data_max, data_or


def compute_ctx(
    state: R.RedState,
    aux: R.Aux,
    requires: frozenset,
    *,
    backend: str = "torch",
    plan: Optional[SegPlan] = None,
) -> R.SweepCtx:
    """Compute exactly the requested aggregates into a SweepCtx.

    On the blocked/cuda backends everything — edge sums/maxes AND the window
    activity/clique bits — comes out of ONE fused pass over the packed edge
    blocks."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown aggregate backend {backend!r}")
    if backend != "torch" and plan is None:
        raise ValueError(f"backend {backend!r} needs a SegPlan (got None)")
    V = state.w.shape[0]
    D = aux.window.shape[1]
    active = R._active(state)
    S = deg = M = only = act_bits = clique = None
    need_bits = bool(requires & {"act_bits", "clique"})
    sum_fields, max_fields, data_sum, data_max, data_or = ctx_payloads(
        state, aux, requires, window_bits=backend != "torch", plan=plan,
    )
    sums = maxs = ors = None
    if data_sum is not None or data_max is not None or data_or is not None:
        sums, maxs, _, ors = aggregate(
            aux.row, V, data_sum=data_sum, data_max=data_max,
            data_or=data_or, or_nbits=max(D, 1), backend=backend, plan=plan,
        )
    out = {}
    for i, f in enumerate(sum_fields):
        out[f] = sums[:, i]
    for i, f in enumerate(max_fields):
        out[f] = maxs[:, i]
    S, deg = out.get("S"), out.get("deg")
    if "M" in out:
        M = out["M"]
    if "only" in out:
        only = out["only"].clamp(min=0)

    if need_bits:
        if backend == "torch":
            act_bits = W.window_active_bits(active, aux.gid, aux.window)
            if "clique" in requires:
                clique = W.window_clique_ok(act_bits, aux.win_adj_bits)
        else:
            act_bits = ors[:, 0]
            if "clique" in requires:
                clique = (act_bits & ors[:, 1]) == 0
    if "act_bits" not in requires:
        act_bits = None
    return R.SweepCtx(
        S=S, deg=deg, M=M, only=only, act_bits=act_bits, clique=clique
    )


# --------------------------------------------------------------------- #
# one sweep of the scheduled rules
# --------------------------------------------------------------------- #
def sweep(
    state: R.RedState,
    aux: R.Aux,
    *,
    schedule: str = "cheap",
    backend: str = "torch",
    plan: Optional[SegPlan] = None,
) -> R.RedState:
    """One pass of the scheduled rule families.

    refresh="sweep": the union of the schedule's aggregate requirements is
    computed ONCE and shared by every family (tests conservatively stale,
    applications fresh).  refresh="rule": each family gets its declared
    aggregates recomputed at rule entry."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown rule schedule {schedule!r}; "
            f"available: {sorted(SCHEDULES)}"
        )
    sched = SCHEDULES[schedule]
    if sched.refresh == "sweep":
        ctx = compute_ctx(
            state, aux, schedule_requires(sched), backend=backend, plan=plan
        )
        for name in sched.rules:
            state = RULES[name](state, aux, ctx)
    else:
        for name in sched.rules:
            ctx = compute_ctx(
                state, aux, RULES[name].requires, backend=backend, plan=plan
            )
            state = RULES[name](state, aux, ctx)
    return state
