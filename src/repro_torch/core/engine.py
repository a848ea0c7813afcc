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

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rules as R
from repro_torch.kernels.segment_coo.ops import (
    pack_blocks, segment_fused_coo, segment_fused_plain,
)
from repro_torch.kernels.segment_coo.ref import (
    segment_max, segment_min, segment_or_ref, segment_sum,
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
    built without window structure)."""

    edge_perm: torch.Tensor   # [n_blocks, E_BLK] i32
    lrow: torch.Tensor        # [n_blocks, E_BLK] i32 (r_blk = padding)
    r_blk: int                # row-block height
    wbits: Optional[torch.Tensor] = None  # [E] i32 window-position bits
    wnh: Optional[torch.Tensor] = None    # [E] i32 clique-violation masks


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
    return SegPlan(edge_perm=dev(perm), lrow=dev(lrow), r_blk=r_blk,
                   wbits=wbits, wnh=wnh)


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
    precomputed ``plan``)."""
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
        fused = segment_fused_coo if backend == "cuda" else segment_fused_plain
        outs = fused(
            plan.edge_perm, plan.lrow, n_rows,
            data_sum=d_sum, data_max=d_max, data_min=d_min, data_or=d_or,
            or_nbits=or_nbits, r_blk=plan.r_blk,
        )
    return tuple(
        o[:, 0] if o is not None and sq else o
        for o, sq in zip(outs, squeeze)
    )


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
