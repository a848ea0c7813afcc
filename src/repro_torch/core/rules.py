"""Vectorized masked reduction rules — the paper's §4.3 over torch tensors.

Port of :mod:`repro.core.rules`; the module docstring there gives the
batching-soundness argument (deterministic gid-priority filters on include,
exclude and weight-transfer rules) and the ghost semantics, which carry over
unchanged.  Every rule is evaluated for *all* vertices of the (union) graph
at once: segment reductions over the edge list plus static capped neighbor
windows.

Torch idiom against the JAX reference:

  * tensors are never updated in place — every scatter writes into a fresh
    clone, so a caller's snapshot of ``state.w`` / ``state.status`` stays
    valid (the round loops compare against them);
  * scatters write only their firing lanes, compacted by one ``nonzero``
    (one host sync each).  The reference's ``.at[where(mask, i, nil)]``
    idiom parks every other lane on the last slot of the target, which on
    CUDA makes each of them an atomic or a store on one address; dropping
    those lanes keeps every bit, because that slot is reset (``w[nil] = 0``)
    or already holds what they wrote (the nil vertex stays EXCLUDED, the fold
    log's ``cap - 1`` sentinel stays 0).  Repeated firing indices only ever
    write equal values to one slot, because ``index_put_`` on CUDA keeps an
    arbitrary writer;
  * every sum over int32 passes ``dtype=torch.int32`` so ``offset`` /
    ``log_n`` wrap as JAX's int32 do; ``status`` is int8 throughout.

Rule tests read their neighborhood aggregates from a :class:`SweepCtx` that
the engine (:mod:`repro_torch.core.engine`) fills through its pluggable
backend; rule *applications* always read fresh status.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.segment_coo.ref import segment_max, segment_sum
from repro_torch.kernels.wedge_intersect.ops import window_active_bits

I32 = torch.int32
I8 = torch.int8


def _requires(*aggs: str):
    """Declare which SweepCtx aggregates a rule's test consumes."""
    unknown = set(aggs) - set(SweepCtx._fields)
    if unknown:
        raise ValueError(
            f"unknown aggregate(s) {sorted(unknown)}; "
            f"SweepCtx fields are {SweepCtx._fields}"
        )

    def deco(fn):
        fn.requires = frozenset(aggs)
        return fn

    return deco


UNDECIDED, INCLUDED, EXCLUDED, FOLDED = 0, 1, 2, 3
LOG_FOLD1, LOG_WT = 1, 2

I32_MIN = torch.iinfo(torch.int32).min


class Aux(NamedTuple):
    """Static (per-PE or union) graph structure; never modified."""

    row: torch.Tensor            # [E] i32 source idx (pad = nil)
    col: torch.Tensor            # [E] i32 target idx (pad = nil)
    gid: torch.Tensor            # [V] i32 global id (nil/pad = -1)
    is_local: torch.Tensor       # [V] bool
    is_iface: torch.Tensor       # [V] bool
    owner_rank: torch.Tensor     # [V] i32 owning PE (tie-breaking, Lemma 4.5)
    window: torch.Tensor         # [V, D] i32 capped neighbor lists (pad = nil)
    win_complete: torch.Tensor   # [V] bool
    win_adj_bits: torch.Tensor   # [V, D] i32 static pairwise adjacency bits
    edge_common: torch.Tensor    # [E, Dc] i32 capped common neighborhoods


class RedState(NamedTuple):
    """Reduction state.  Fields are replaced, never written in place."""

    w: torch.Tensor         # [V] i32 current weights
    status: torch.Tensor    # [V] i8
    log_kind: torch.Tensor  # [LOG] i8   (fold log for reconstruction)
    log_v: torch.Tensor     # [LOG] i32
    log_u: torch.Tensor     # [LOG] i32
    log_n: torch.Tensor     # [] i32
    offset: torch.Tensor    # [] i32  (weight reclaimed by folds; reporting)
    changed: torch.Tensor   # [] bool (any rule fired in the current sweep)


def init_state(w0: torch.Tensor, is_local: torch.Tensor,
               is_ghost: torch.Tensor) -> RedState:
    V = w0.shape[0]
    dev = w0.device
    status = torch.where(is_local | is_ghost, UNDECIDED, EXCLUDED).to(I8)
    log_cap = V + 1  # each fold retires one vertex forever => never overflows
    return RedState(
        w=w0.to(I32),
        status=status,
        log_kind=torch.zeros(log_cap, dtype=I8, device=dev),
        log_v=torch.zeros(log_cap, dtype=I32, device=dev),
        log_u=torch.zeros(log_cap, dtype=I32, device=dev),
        log_n=torch.zeros((), dtype=I32, device=dev),
        offset=torch.zeros((), dtype=I32, device=dev),
        changed=torch.zeros((), dtype=torch.bool, device=dev),
    )


# --------------------------------------------------------------------- #
# shared masked aggregates
# --------------------------------------------------------------------- #
def _active(state: RedState) -> torch.Tensor:
    return state.status == UNDECIDED


def _edge_active(aux: Aux, active: torch.Tensor) -> torch.Tensor:
    return active[aux.row] & active[aux.col]


def _aw(state: RedState, active: torch.Tensor) -> torch.Tensor:
    return torch.where(active, state.w, 0)


def _act_deg(aux: Aux, eact: torch.Tensor, V: int) -> torch.Tensor:
    return segment_sum(eact.to(I32), aux.row, V)


def _accept_independent(
    aux: Aux, eact: torch.Tensor, cand: torch.Tensor, V: int
) -> torch.Tensor:
    """Filter include candidates to an independent set (gid priority)."""
    nbr_cand_gid = torch.where(eact & cand[aux.col], aux.gid[aux.col], -1)
    m = torch.clamp(segment_max(nbr_cand_gid, aux.row, V), min=-1)
    return cand & (aux.gid > m)


def _apply_include(
    state: RedState, aux: Aux, eact: torch.Tensor, accept: torch.Tensor
) -> RedState:
    status = torch.where(accept, INCLUDED, state.status).to(I8)
    hit = segment_max(
        (accept[aux.row] & eact).to(I32), aux.col, state.w.shape[0]
    ) > 0
    status = torch.where(hit & (status == UNDECIDED), EXCLUDED, status).to(I8)
    return state._replace(status=status, changed=state.changed | accept.any())


def _lanes(mask: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The lanes where ``mask`` holds, as a ``nonzero`` index tuple in
    ascending (row-major) order.  One host sync: the count sizes it."""
    return mask.nonzero(as_tuple=True)


def _pick(x, lanes):
    """``x`` (mask-shaped, or a Python scalar) at the firing lanes."""
    return x[lanes] if torch.is_tensor(x) else x


def _set_at(dst: torch.Tensor, lanes, idx: torch.Tensor, val) -> torch.Tensor:
    """``dst.at[idx].set(val)`` over the firing lanes, into a fresh tensor
    (equal values only at repeated indices — see the module docstring)."""
    out = dst.clone()
    out[_pick(idx, lanes)] = _pick(val, lanes)
    return out


def _add_at(dst: torch.Tensor, lanes, idx: torch.Tensor,
            val: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].add(val)`` over the firing lanes, into a fresh tensor."""
    return dst.clone().index_add_(0, _pick(idx, lanes),
                                  _pick(val, lanes).to(dst.dtype))


def _amax_at(dst: torch.Tensor, lanes, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].max(val)`` over the firing lanes, into a fresh tensor."""
    return dst.clone().scatter_reduce_(
        0, _pick(idx, lanes).long(), _pick(val, lanes).to(dst.dtype), "amax",
        include_self=True,
    )


def _log_append(
    state: RedState, mask: torch.Tensor, lanes, kind: int,
    v_idx: torch.Tensor, u_idx: torch.Tensor
) -> RedState:
    """Append one record per firing lane (``lanes`` = ``_lanes(mask)``), in
    lane order.  Slots past ``log_n`` stay 0: the reference's ``cap - 1``
    sentinel, where it parks the other lanes, is one of them."""
    pos = state.log_n + torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    log_kind = _set_at(state.log_kind, lanes, pos, kind)
    log_v = _set_at(state.log_v, lanes, pos, v_idx)
    log_u = _set_at(state.log_u, lanes, pos, u_idx)
    n = state.log_n + mask.sum(dtype=I32)
    return state._replace(log_kind=log_kind, log_v=log_v, log_u=log_u, log_n=n)


class SweepCtx(NamedTuple):
    """Rule-test aggregates, produced by the engine's pluggable backend.

    The engine fills exactly the fields the scheduled rules declared via
    ``@_requires`` — undeclared fields are ``None``, so a rule reading past
    its declaration fails loudly.  Snapshot aggregates (refresh="sweep") are
    upper bounds of their fresh values, so every test stays sound (see
    ``repro.core.rules.SweepCtx``)."""

    S: Optional[torch.Tensor]         # [V] neighborhood weight sums
    deg: Optional[torch.Tensor]       # [V] active degrees
    M: Optional[torch.Tensor]         # [V] max neighbor weight
    only: Optional[torch.Tensor]      # [V] the unique active neighbor (deg-1)
    act_bits: Optional[torch.Tensor]  # [V] window active bits
    clique: Optional[torch.Tensor]    # [V] active window forms a clique


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


# --------------------------------------------------------------------- #
# rule: degree zero / one  (Meta rule + Remark 4.8, fold form of Gu et al.)
# --------------------------------------------------------------------- #
@_requires("deg", "only")
def rule_degree_one(state: RedState, aux: Aux, ctx: SweepCtx) -> RedState:
    V = state.w.shape[0]
    active = _active(state)
    eact = _edge_active(aux, active)
    deg, only = ctx.deg, ctx.only
    w_u = state.w[only]

    # (a) isolated vertices
    acc0 = aux.is_local & active & (deg == 0)
    state = _apply_include(state, aux, eact, acc0)

    # (b) degree-one include: w(v) >= w_i(u)  — upper bound is enough
    #     (ghost case: propose per Remark 4.6)
    active = _active(state)
    eact = _edge_active(aux, active)
    cand = aux.is_local & active & (deg == 1) & (state.w >= w_u)
    acc1 = _accept_independent(aux, eact, cand, V)
    state = _apply_include(state, aux, eact, acc1)

    # (c) degree-one fold: w(v) < w(u), u local:
    #       w(u) -= w(v);  v FOLDED;  v ∈ I  iff  u ∉ I.
    active = _active(state)
    cand = aux.is_local & active & (deg == 1) & (state.w < w_u)
    cand &= aux.is_local[only] & active[only]
    # one fold per target u per sweep: keep the max-gid candidate
    best = _amax_at(torch.full_like(state.w, -1), _lanes(cand), only,
                    aux.gid)
    acc = cand & (aux.gid == best[only])
    fold = _lanes(acc)
    w = _add_at(state.w, fold, only, -state.w)
    w[V - 1] = 0  # the reference's nil-slot reset
    status = torch.where(acc, FOLDED, state.status).to(I8)
    offset = state.offset + torch.where(acc, state.w, 0).sum(dtype=I32)
    state = state._replace(
        w=w, status=status, offset=offset, changed=state.changed | acc.any()
    )
    return _log_append(state, acc, fold, LOG_FOLD1, _arange(V, w),
                       only.to(I32))


# --------------------------------------------------------------------- #
# rule: Dist. Neighborhood Removal (Reduction 4.3)
# --------------------------------------------------------------------- #
@_requires("S")
def rule_neighborhood_removal(state: RedState, aux: Aux,
                              ctx: SweepCtx) -> RedState:
    V = state.w.shape[0]
    active = _active(state)
    eact = _edge_active(aux, active)
    cand = aux.is_local & active & (state.w >= ctx.S)
    acc = _accept_independent(aux, eact, cand, V)
    return _apply_include(state, aux, eact, acc)


# --------------------------------------------------------------------- #
# rule: Distributed Simplicial Vertex (Reduction 4.4)
# --------------------------------------------------------------------- #
@_requires("clique", "M")
def rule_simplicial(state: RedState, aux: Aux, ctx: SweepCtx) -> RedState:
    V = state.w.shape[0]
    active = _active(state)
    eact = _edge_active(aux, active)
    cand = (
        aux.is_local & active & aux.win_complete & ctx.clique
        & (state.w >= ctx.M)
    )
    acc = _accept_independent(aux, eact, cand, V)
    return _apply_include(state, aux, eact, acc)


# --------------------------------------------------------------------- #
# rule: Dist. Simplicial Weight Transfer (Reduction 4.5)
# --------------------------------------------------------------------- #
@_requires("clique", "M", "deg")
def rule_weight_transfer(state: RedState, aux: Aux,
                         ctx: SweepCtx) -> RedState:
    V = state.w.shape[0]
    D = aux.window.shape[1]
    active = _active(state)
    eact = _edge_active(aux, active)
    clique, m, deg = ctx.clique, ctx.M, ctx.deg

    # v must be max-weight among the simplicial vertices of N(v).  A neighbor
    # whose simpliciality we cannot decide (incomplete window) blocks v.
    simpl_known = aux.win_complete & clique
    nbr_blocks = eact & (state.w[aux.col] > state.w[aux.row]) & (
        simpl_known[aux.col] | ~aux.win_complete[aux.col]
    )
    blocked = segment_max(nbr_blocks.to(I32), aux.row, V) > 0

    cand = (
        aux.is_local & active & ~aux.is_iface & simpl_known
        & (state.w < m) & ~blocked & (deg >= 1)
    )
    # unique within two hops (gid priority) => disjoint closed neighborhoods
    m1 = segment_max(
        torch.where(eact & cand[aux.col], aux.gid[aux.col], -1), aux.row, V
    ).clamp(min=-1)
    m2 = segment_max(
        torch.where(eact, m1[aux.col], -1), aux.row, V
    ).clamp(min=-1)
    acc = cand & (aux.gid > m1) & (aux.gid >= m2)

    # apply the fold: remove X = {u in N[v]: w(u) <= w(v)}, transfer weight.
    # entry activity here must be FRESH (application, not test)
    fresh_bits = window_active_bits(_active(state), aux.gid, aux.window)
    wv = state.w
    tgt = aux.window  # [V, D]
    shifts = _arange(D, wv)
    ent_active = ((fresh_bits[:, None] >> shifts) & 1) == 1
    accb = acc[:, None]
    w_tgt = state.w[tgt]
    excl_upd = accb & ent_active & (w_tgt <= wv[:, None])
    dec_upd = accb & ent_active & (w_tgt > wv[:, None])
    status = _set_at(state.status, _lanes(excl_upd), tgt, EXCLUDED)
    status = torch.where(acc, FOLDED, status).to(I8)
    w = _add_at(state.w, _lanes(dec_upd), tgt, (-wv[:, None]).expand_as(tgt))
    w[V - 1] = 0  # the reference's nil-slot reset
    offset = state.offset + torch.where(acc, wv, 0).sum(dtype=I32)
    state = state._replace(
        w=w, status=status, offset=offset, changed=state.changed | acc.any()
    )
    idx = _arange(V, w)
    return _log_append(state, acc, _lanes(acc), LOG_WT, idx, idx)


# --------------------------------------------------------------------- #
# rule: Distributed Basic Single-Edge (Reduction 4.6)
# --------------------------------------------------------------------- #
@_requires("S")
def rule_basic_single_edge(state: RedState, aux: Aux,
                           ctx: SweepCtx) -> RedState:
    V = state.w.shape[0]
    active = _active(state)
    eact = _edge_active(aux, active)
    aw = _aw(state, active)
    # capped common-neighborhood weight (lower bound => conservative)
    ec = aux.edge_common
    c = torch.where(active[ec], aw[ec], 0).sum(dim=1, dtype=I32)
    val = ctx.S[aux.row] - c  # >= true ω(N(u) \ N(v)) which contains v
    test = (
        eact
        & aux.is_local[aux.row] & aux.is_local[aux.col]
        & (val <= state.w[aux.row])
        & (aux.gid[aux.row] > aux.gid[aux.col])  # ascending certificate chain
    )
    excl = segment_max(test.to(I32), aux.col, V) > 0
    fire = excl & active & aux.is_local
    status = torch.where(fire, EXCLUDED, state.status).to(I8)
    return state._replace(status=status, changed=state.changed | fire.any())


# --------------------------------------------------------------------- #
# rule: Dist. Extended Single-Edge (Reduction 4.7)
# --------------------------------------------------------------------- #
@_requires("S")
def rule_extended_single_edge(state: RedState, aux: Aux,
                              ctx: SweepCtx) -> RedState:
    active = _active(state)
    eact = _edge_active(aux, active)
    aw = _aw(state, active)
    # edge e = (v=row, u=col):  w(v) >= S(v) - aw(u)  => exclude common nbrs
    test = (
        eact
        & aux.is_local[aux.row] & aux.is_local[aux.col]
        & (ctx.S[aux.row] - aw[aux.col] <= state.w[aux.row])
    )
    min_gid = torch.minimum(aux.gid[aux.row], aux.gid[aux.col])
    tgt = aux.edge_common  # [E, Dc]
    gid_t = aux.gid[tgt]
    upd = (
        test[:, None]
        & active[tgt] & aux.is_local[tgt]
        & (gid_t < min_gid[:, None])
        & (gid_t >= 0)
    )
    status = _set_at(state.status, _lanes(upd), tgt, EXCLUDED)
    return state._replace(status=status, changed=state.changed | upd.any())


# --------------------------------------------------------------------- #
# rule: Distributed Heavy Vertex (Reduction 4.2) — exact sub-MWIS
# --------------------------------------------------------------------- #
def _alpha_neighborhood(
    w: torch.Tensor, status: torch.Tensor, aux: Aux, heavy_k: int
) -> torch.Tensor:
    """[V] i32 — exact α(G_i[N_i(v)]) for active windows with ≤K active
    entries; 2^K subset enumeration against static adjacency bitmasks."""
    V, D = aux.window.shape
    K = heavy_k
    active = status == UNDECIDED
    ent_ok = active[aux.window] & (aux.gid[aux.window] >= 0)  # [V, D]
    # stable-sort entries: active first, keep the first K
    order = torch.argsort(
        (~ent_ok).to(I8), dim=1, stable=True
    )[:, :K]                                                 # [V, K]
    ent = torch.gather(aux.window, 1, order)                 # [V, K]
    ent_act = torch.gather(ent_ok, 1, order)                 # [V, K]
    wk = torch.where(ent_act, w[ent], 0).to(I32)             # [V, K]
    # permuted adjacency bits: bit j of row i = adjacency(order_i, order_j)
    bits_full = torch.gather(aux.win_adj_bits, 1, order)     # [V, K]
    order = order.to(I32)
    adj = torch.zeros((V, K), dtype=I32, device=w.device)
    for j in range(K):
        bit_j = (bits_full >> order[:, j : j + 1]) & 1       # [V, K]
        adj |= bit_j << j
    subsets = _arange(1 << K, w)                             # [T]
    sel = (subsets[:, None] >> _arange(K, w)[None, :]) & 1   # [T, K]
    # wk @ sel.T as an exact int32 sum over the K columns (torch has no
    # int32 matmul on CUDA)
    totals = torch.zeros((V, 1 << K), dtype=I32, device=w.device)
    for k in range(K):
        totals += wk[:, k : k + 1] * sel[None, :, k]
    conflict = torch.zeros(totals.shape, dtype=torch.bool, device=w.device)
    for i in range(K):
        in_sub = sel[:, i] == 1                              # [T]
        hits = (subsets[None, :] & adj[:, i : i + 1]) != 0   # [V, T]
        conflict |= in_sub[None, :] & hits
    alpha = torch.where(conflict, -1, totals).amax(dim=1)
    return alpha.clamp(min=0)


def rule_heavy_vertex(state: RedState, aux: Aux,
                      heavy_k: int = 8) -> RedState:
    V = state.w.shape[0]
    active = _active(state)
    eact = _edge_active(aux, active)
    deg = _act_deg(aux, eact, V)
    alpha = _alpha_neighborhood(state.w, state.status, aux, heavy_k)
    cand = (
        aux.is_local & active & aux.win_complete
        & (deg <= heavy_k) & (state.w >= alpha)
    )
    acc = _accept_independent(aux, eact, cand, V)
    return _apply_include(state, aux, eact, acc)


def reconstruct_members(state: RedState, aux: Aux) -> torch.Tensor:
    """Replay the fold log in reverse; returns [V] bool membership.

    INCLUDED statuses seed the set; FOLD1 (v ∈ I ⟺ u ∉ I) and WT
    (v ∈ I ⟺ I ∩ N(v) = ∅, window-complete by rule gating) records replay
    newest-first.  All record targets are local by rule construction.

    The replay is sequential by nature, so it runs in one pass on the host
    over one copy of the log and of the WT records' window rows, instead of
    per-record tensor ops on the device.  It visits exactly ``log_n``
    records, so the reference's phantom-iteration guard (iterations past
    ``log_n`` write the inert nil slot) has nothing to guard here.
    """
    in_set = (state.status == INCLUDED).cpu().numpy()
    n = int(state.log_n)
    if n == 0:
        return torch.from_numpy(in_set).to(state.status.device)
    kind = state.log_kind[:n].cpu().numpy()
    v = state.log_v[:n].cpu().numpy()
    u = state.log_u[:n].cpu().numpy()
    wt = torch.from_numpy(np.flatnonzero(kind != LOG_FOLD1)).to(
        aux.window.device
    )
    rows = aux.window[state.log_v[:n][wt].long()]          # [n_wt, D]
    real = (aux.gid[rows] >= 0).cpu().numpy()
    rows = rows.cpu().numpy()
    wt_row = np.full(n, -1, np.int64)
    wt_row[wt.cpu().numpy()] = np.arange(rows.shape[0])
    member = in_set.tolist()
    for k in range(n - 1, -1, -1):
        if kind[k] == LOG_FOLD1:
            val = not member[u[k]]
        else:
            r = wt_row[k]
            val = not any(member[e] for e in rows[r][real[r]].tolist())
        member[v[k]] = val
    return torch.tensor(member, dtype=torch.bool, device=state.status.device)
