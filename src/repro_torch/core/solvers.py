"""Distributed MWIS solvers (§6): GS/GA, RGS/RGA, RnPS/RnPA — union path.

Port of the union half of :mod:`repro.core.solvers`:

  * greedy (GS/GA)          — distributed weighted Luby: a vertex joins the
    solution iff its (weight, gid) is lexicographically maximal over its
    active neighborhood; border synchronized every round.  Deterministic ==
    sequential priority greedy (``sequential.solve_greedy``).
  * reduce-and-greedy (RGS/RGA) — DisRedu{S,A} to the global fixpoint, then
    greedy on the kernel.
  * reduce-and-peel (RnPS/RnPA) — loop { reduce to fixpoint; every PE peels
    its locally worst vertex argmax ω(N(v)) − ω(v) } until empty.

The algorithm bodies are written over an abstract :class:`Ctx` (exchange,
global-any, per-PE peel); :func:`_union_ctx` instantiates it for the union
layout.  Every ``lax.while_loop`` of the reference is a host loop reading
one device flag per trip, with the reference's trip count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import exchange as X
from repro_torch.core import rules as R
from repro_torch.core.distributed import (
    DisReduConfig, UnionProblem, build_union_problem, moved,
)
from repro_torch.core.local_reduce import local_reduce
from repro_torch.core.partition import PartitionedGraph

UNDECIDED, INCLUDED, EXCLUDED, FOLDED = 0, 1, 2, 3
I32 = torch.int32
I32_MIN = torch.iinfo(torch.int32).min


class Ctx(NamedTuple):
    """Abstract SPMD context: exchange + global-any + per-PE peel."""

    exchange: Callable  # state -> (state, changed)
    gany: Callable      # bool tensor -> bool (global OR, read on the host)
    peel: Callable      # (state, score [V]) -> state  (one peel per PE)


# --------------------------------------------------------------------- #
# algorithm bodies (layout-agnostic)
# --------------------------------------------------------------------- #
def _reduce_to_fixpoint(state, aux, ctx: Ctx, cfg: DisReduConfig,
                        plan=None):
    rounds, changed = 0, True
    while changed and rounds < cfg.max_rounds:
        snap_s, snap_w = state.status, state.w
        state = local_reduce(
            state, aux, heavy_k=cfg.heavy_k, use_heavy=cfg.use_heavy,
            max_sweeps=cfg.sweeps_per_round, schedule=cfg.schedule,
            backend=cfg.backend, plan=plan,
        )
        state, _ = ctx.exchange(state)
        changed = moved(state, snap_s, snap_w)
        rounds += 1
    return state, rounds


def greedy_step(state, aux, *, backend: str = "torch", plan=None):
    """One weighted-Luby round (no exchange): include every local active
    vertex no active neighbor beats — v wins iff no neighbor u has
    (w[u], -gid[u]) lexicographically above (w[v], -gid[v]), one pass
    through the aggregate backend."""
    V = aux.gid.shape[0]
    active = state.status == UNDECIDED
    eact = active[aux.row] & active[aux.col]
    wc, wr = state.w[aux.col], state.w[aux.row]
    beat_e = eact & (
        (wc > wr) | ((wc == wr) & (aux.gid[aux.col] < aux.gid[aux.row]))
    )
    _, beaten, _, _ = E.aggregate(
        aux.row, V, data_max=beat_e.to(I32), backend=backend, plan=plan,
    )
    win = aux.is_local & active & (beaten <= 0)
    return R._apply_include(state, aux, eact, win)


def _remaining(state, aux, ctx: Ctx) -> bool:
    return ctx.gany((aux.is_local & (state.status == UNDECIDED)).any())


def _greedy_rounds(state, aux, ctx: Ctx, max_rounds: int = 100_000,
                   *, backend: str = "torch", plan=None):
    """Weighted-Luby rounds until no vertex is UNDECIDED anywhere."""
    rounds, remaining = 0, _remaining(state, aux, ctx)
    while remaining and rounds < max_rounds:
        state = greedy_step(state, aux, backend=backend, plan=plan)
        state, _ = ctx.exchange(state)
        remaining = _remaining(state, aux, ctx)
        rounds += 1
    return state


def peel_score(state, aux, *, backend: str = "torch", plan=None):
    """[V] HtWIS peel score ω(N(v)) − ω(v) for local active vertices
    (I32_MIN elsewhere), through the aggregate backend."""
    V = aux.gid.shape[0]
    active = state.status == UNDECIDED
    eact = active[aux.row] & active[aux.col]
    aw = torch.where(active, state.w, 0)
    s, _, _, _ = E.aggregate(
        aux.row, V, data_sum=torch.where(eact, aw[aux.col], 0),
        backend=backend, plan=plan,
    )
    return torch.where(aux.is_local & active, s - state.w, I32_MIN)


def _rnp_loop(state, aux, ctx: Ctx, cfg: DisReduConfig,
              max_peels: int = 1_000_000, plan=None):
    """reduce → peel-one-per-PE → repeat until globally empty (§6).
    Returns (state, peel iterations)."""
    it, remaining = 0, _remaining(state, aux, ctx)
    while remaining and it < max_peels:
        state, _ = _reduce_to_fixpoint(state, aux, ctx, cfg, plan=plan)
        score = peel_score(state, aux, backend=cfg.backend, plan=plan)
        state = ctx.peel(state, score)
        remaining = _remaining(state, aux, ctx)
        it += 1
    return state, it


def run_algorithm(state, aux, ctx: Ctx, cfg: DisReduConfig, algo: str,
                  plan=None):
    """algo ∈ {reduce, greedy, rg, rnp} → (final state, loop trips): all
    local vertices decided for the solver algos, the kernel left for
    'reduce'.  Trips are reduce rounds for 'reduce', peel iterations for
    'rnp' and 0 otherwise."""
    trips = 0
    if algo == "reduce":
        state, trips = _reduce_to_fixpoint(state, aux, ctx, cfg, plan=plan)
    elif algo == "greedy":
        state = _greedy_rounds(state, aux, ctx, backend=cfg.backend,
                               plan=plan)
    elif algo == "rg":
        state, _ = _reduce_to_fixpoint(state, aux, ctx, cfg, plan=plan)
        state = _greedy_rounds(state, aux, ctx, backend=cfg.backend,
                               plan=plan)
    elif algo == "rnp":
        state, trips = _rnp_loop(state, aux, ctx, cfg, plan=plan)
    else:
        raise ValueError(f"unknown algo {algo!r}")
    return state, trips


# --------------------------------------------------------------------- #
# union instantiation (single-device SPMD simulation)
# --------------------------------------------------------------------- #
def _union_ctx(prob: UnionProblem, backend: str = "torch") -> Ctx:
    p, V = prob.p, prob.w0.shape[0] // prob.p

    def exch(state):
        return X.exchange_union(
            state, prob.aux, prob.halo, backend=backend, plan=prob.plan,
        )

    def peel(state, score):
        sc = score.reshape(p, V)
        top = torch.argmax(sc, dim=1)        # first index among ties
        pes = torch.arange(p, device=sc.device)
        has = sc[pes, top] > I32_MIN
        flat = torch.where(has, top + pes * V, p * V - 1)
        # exclude the per-PE argmax; the nil slot (EXCLUDED already)
        # absorbs PEs with nothing left to peel
        status = state.status.clone()
        status[flat] = EXCLUDED
        return state._replace(status=status)

    return Ctx(exchange=exch, gany=bool, peel=peel)


def solve_union(prob: UnionProblem, algo: str, cfg: DisReduConfig):
    """Union-path solve body: problem in, (state, members [V] bool, loop
    trips) out."""
    ctx = _union_ctx(prob, cfg.backend)
    state = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    state, trips = run_algorithm(state, prob.aux, ctx, cfg, algo,
                                 plan=prob.plan)
    return state, R.reconstruct_members(state, prob.aux), trips


def solve_union_arrays(w0, is_local, is_ghost, aux, halo, plan, *, algo,
                       heavy_k, use_heavy, sweeps, max_rounds, p,
                       schedule="cheap", backend="torch"):
    """Union-path solve body over plain tensors: ``(state, members [p, V])``.

    The batch seam of the serving layer (the reference vmaps its
    counterpart).  Here the batch is the union layout itself: B single-PE
    instances stacked by :func:`~repro_torch.core.distributed.
    stack_problems` go in as one p=B problem, and row b of ``members`` is
    instance b's [V] membership.  Per instance this is the single-instance
    solve bit for bit: every payload is int32, rules, greedy rounds and
    peels act per vertex over edges that stay inside an instance, the peel
    takes one vertex per PE, and every round body is idempotent at its
    fixpoint — an instance that finishes early is unchanged by the trips
    its batchmates still need.  ``state.offset`` is ONE int32 over the
    union, so no per-instance offset can be read from a batched state (the
    serving layer recomputes each weight from the request's weights)."""
    V = w0.shape[0] // p
    prob = UnionProblem(w0, is_local, is_ghost, aux, halo, p, V, plan)
    cfg = DisReduConfig(
        heavy_k=heavy_k, use_heavy=use_heavy,
        mode="sync" if sweeps >= 1_000_000 else "async",
        stale_sweeps=sweeps, max_rounds=max_rounds, schedule=schedule,
        backend=backend,
    )
    state, members, _ = solve_union(prob, algo, cfg)
    return state, members.reshape(p, V)


def solve(
    pg: PartitionedGraph,
    algo: str,
    cfg: DisReduConfig = DisReduConfig(),
    device: torch.device | str | None = None,
) -> Tuple[np.ndarray, R.RedState]:
    """Solve MWIS heuristically; returns (global member mask, final state).

    algo: 'greedy' (GS/GA), 'rg' (RGS/RGA), 'rnp' (RnPS/RnPA) — the S/A
    flavour is chosen by cfg.mode ('sync'/'async').
    """
    prob = build_union_problem(pg, cfg.backend, cfg.r_blk, device)
    state, in_set, _ = solve_union(prob, algo, cfg)
    return global_members(pg, prob, in_set), state


def global_members(pg: PartitionedGraph, prob: UnionProblem,
                   in_set: torch.Tensor) -> np.ndarray:
    """[n_global] bool member mask from the union-layout membership."""
    members = np.zeros(pg.n_global, dtype=bool)
    sel = in_set.cpu().numpy() & prob.is_local.cpu().numpy()
    members[prob.aux.gid.cpu().numpy()[sel]] = True
    return members
