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
layout and :func:`solver_shard_map_fn` for the per-PE path (one rank of a
``torch.distributed`` process group a PE; ``launch.mesh.run_shard_map``
starts the ranks and runs jobs on them), where
:func:`sweep_probe_shard_map_fn` is the dry-run's one-sweep-round probe.
Every ``lax.while_loop`` of the reference is a host loop reading one
device flag per trip (on the per-PE path, its OR over the ranks), with
the reference's trip count.

:func:`solve_staged` is the staged solve with adaptive shape descent: the
same loop bodies run in bounded stages, and between stages the alive
kernel is re-packed onto smaller cells of a static shape ladder.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import mwis as CFG
from repro_torch.core import distributed as D
from repro_torch.core import engine as E
from repro_torch.core import exchange as X
from repro_torch.core import partition as part
from repro_torch.core import rules as R
from repro_torch.core.distributed import (
    DisReduConfig, UnionProblem, build_union_problem,
)
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
    state, rounds, _ = D.reduce_rounds(state, aux, ctx.exchange, ctx.gany,
                                       cfg, plan=plan)
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
    """Weighted-Luby rounds until no vertex is UNDECIDED anywhere (or
    ``max_rounds``); returns (state, rounds, remaining)."""
    rounds, remaining = 0, _remaining(state, aux, ctx)
    while remaining and rounds < max_rounds:
        state = greedy_step(state, aux, backend=backend, plan=plan)
        state, _ = ctx.exchange(state)
        remaining = _remaining(state, aux, ctx)
        rounds += 1
    return state, rounds, remaining


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
        state, _, _ = _greedy_rounds(state, aux, ctx, backend=cfg.backend,
                                     plan=plan)
    elif algo == "rg":
        state, _ = _reduce_to_fixpoint(state, aux, ctx, cfg, plan=plan)
        state, _, _ = _greedy_rounds(state, aux, ctx, backend=cfg.backend,
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


# --------------------------------------------------------------------- #
# per-PE instantiation (one rank of a torch.distributed group a PE)
# --------------------------------------------------------------------- #
def solver_shard_map_fn(a, cfg: DisReduConfig, algo: str, *, group=None,
                        device: torch.device | str | None = None):
    """Solve on this rank's PE: ``(state, members [V] bool, loop trips)``.

    ``a`` is this rank's row of :func:`~repro_torch.core.distributed.
    shard_map_arrays`; ``group`` is the PEs' process group (the reference's
    shard_map mesh; default: the default group).  The :class:`Ctx`
    exchanges by ``cfg.exchange`` over the group's collectives, ORs flags
    with ``all_reduce`` and peels the PE's own argmax (first index among
    ties; its nil slot ``V-1`` when nothing is left), as the reference's
    ``solver_shard_map_fn`` does inside shard_map.  The reference returns
    the shard_map'd function; here each rank calls this directly."""
    dev = resolve_device(device)
    aux, halo, plan, t = D._unpack_per_pe(a, dev)

    def exch(state):
        return X.exchange_shmap(
            state, aux, halo, group=group, method=cfg.exchange,
            backend=cfg.backend, plan=plan,
        )

    def peel(state, score):
        top = torch.argmax(score)
        idx = torch.where(score[top] > I32_MIN, top, score.shape[0] - 1)
        status = state.status.clone()
        status[idx] = EXCLUDED
        return state._replace(status=status)

    ctx = Ctx(exchange=exch, gany=lambda x: X.global_any(x, group),
              peel=peel)
    state = R.init_state(t["w0"], t["is_local"], t["is_ghost"])
    state, trips = run_algorithm(state, aux, ctx, cfg, algo, plan=plan)
    return state, R.reconstruct_members(state, aux), trips


def sweep_probe_shard_map_fn(a, cfg: DisReduConfig, *, group=None,
                             device: torch.device | str | None = None):
    """Loop-free roofline probe on this rank's PE: exactly ONE rule sweep
    (``cfg.schedule``) + ONE heavy-vertex pass (if ``cfg.use_heavy``) +
    ONE halo exchange (``cfg.exchange`` over ``group``) from the initial
    state; returns ``(w, status, offset)``.  DisRedu's loops have
    data-dependent trip counts, so the dry-run's unit is one sweep-round.

    ``a`` is this rank's row of :func:`~repro_torch.core.distributed.
    shard_map_arrays`, taken as :func:`solver_shard_map_fn` takes it; the
    reference's ``sweep_probe_shard_map_fn`` builds the same body under
    shard_map."""
    dev = resolve_device(device)
    aux, halo, plan, t = D._unpack_per_pe(a, dev)
    state = R.init_state(t["w0"], t["is_local"], t["is_ghost"])
    state = E.sweep(state, aux, schedule=cfg.schedule, backend=cfg.backend,
                    plan=plan)
    if cfg.use_heavy:
        state = R.rule_heavy_vertex(state, aux, cfg.heavy_k)
    state, _ = X.exchange_shmap(state, aux, halo, group=group,
                                method=cfg.exchange, backend=cfg.backend,
                                plan=plan)
    return state.w, state.status, state.offset


# --------------------------------------------------------------------- #
# staged solve with adaptive shape descent (kernel compaction)
# --------------------------------------------------------------------- #
class LadderCell(NamedTuple):
    """One rung of the static shape ladder (serve/descent MWIS_SHAPES
    cells, or ad-hoc test cells).  L/E gate admission; G/B/S floor the
    halo pads (the exact per-PE maxima override them); r_blk picks the
    blocked-ELL row-block height for plans packed at this rung."""

    name: str
    L: int
    E: int
    G: int = 4
    B: int = 4
    S: int = 4
    r_blk: Optional[int] = None


def default_ladder() -> Tuple[LadderCell, ...]:
    """The configured descent ladder: serve cells + descent extensions
    from ``configs.mwis.MWIS_SHAPES``, ascending."""
    cells = []
    for name in CFG.MWIS_DESCENT_LADDER:
        m = CFG.MWIS_SHAPES[name]
        cells.append(LadderCell(
            name=name, L=m["L"], E=m["E"], G=m["G"], B=m["B"], S=m["S"],
            r_blk=m.get("seg_blk", {}).get("r_blk"),
        ))
    return tuple(sorted(cells, key=lambda c: (c.L, c.E)))


class _Frame(NamedTuple):
    """Pre-descent snapshot: the full-shape state (with its fold log) and
    the aux needed to replay reconstruction at that level."""

    state: R.RedState
    aux: R.Aux
    is_local: torch.Tensor


def _stage_union(state, prob: UnionProblem, cfg: DisReduConfig,
                 phase: str, iters: int):
    """One bounded solver stage on the union layout; returns
    ``(state, rounds, flag)``.

    phase='reduce' — ≤ `iters` DisRedu rounds; flag = changed_last, so the
    host loop can tell fixpoint (False) from budget exhaustion even at
    iters=1.
    phase='greedy' — ≤ `iters` weighted-Luby rounds; flag = remaining.
    phase='peel'   — exactly one HtWIS peel per PE (no exchange: ghosts
    are stale until the next reduce round's exchange, which is why the
    staged solve never descends right after a peel); flag = remaining.

    The stages run the monolithic loops' own bodies (``reduce_rounds``,
    :func:`_greedy_rounds`), so resuming a phase across stage boundaries is
    exact: reduce rounds are idempotent at fixpoint, greedy re-evaluates
    `remaining` from the statuses, and the rnp loop body is
    reduce-to-fixpoint + peel.
    """
    ctx = _union_ctx(prob, cfg.backend)
    if phase == "reduce":
        return D.reduce_rounds(state, prob.aux, ctx.exchange, ctx.gany, cfg,
                               plan=prob.plan, max_rounds=iters)
    if phase == "greedy":
        return _greedy_rounds(state, prob.aux, ctx, iters,
                              backend=cfg.backend, plan=prob.plan)
    if phase != "peel":
        raise ValueError(f"unknown stage phase {phase!r}")
    score = peel_score(state, prob.aux, backend=cfg.backend, plan=prob.plan)
    state = ctx.peel(state, score)
    return state, 0, _remaining(state, prob.aux, ctx)


def _pick_cell(ladder, need, cur_L, cur_E, factor):
    """Smallest ladder cell the kernel fits that is a real descent
    (hysteresis: cell.L * factor <= current L, never grow E)."""
    for c in sorted(ladder, key=lambda c: (c.L, c.E)):
        if (c.L * max(factor, 1) <= cur_L and c.E <= cur_E
                and c.L >= need["L"] and c.E >= need["E"]):
            return c
    return None


def _build_level(pg: PartitionedGraph, cfg: DisReduConfig, cell, dev,
                 plan_cache: Optional[E.PlanCache], tag: Optional[str] = None
                 ) -> UnionProblem:
    """The union problem of one descent level: plans packed at the rung's
    ``r_blk`` (``cfg.r_blk`` at the input level or for a rung without
    one) through ``plan_cache`` under ``tag``."""
    r_blk = None
    if cfg.backend != "torch":
        r_blk = cell.r_blk if (cell is not None and cell.r_blk) else cfg.r_blk
    return build_union_problem(pg, cfg.backend, r_blk, dev,
                               plan_cache=plan_cache, plan_tag=tag)


def restore_staged(ckpt, pg: PartitionedGraph, prob: UnionProblem,
                   cfg: DisReduConfig, *, ladder=None,
                   plan_cache: Optional[E.PlanCache] = None,
                   step: Optional[int] = None,
                   device: torch.device | str | None = None):
    """Restore a :func:`solve_staged` checkpoint (``step``, default the
    latest) onto ``device``: the saved frame states, and the compaction
    chain replayed host-side from ``pg`` / ``prob`` (the input level) to
    the level the checkpoint was taken at.  Returns ``(frames, pg, prob,
    state, extra)`` of that level, ``extra`` the manifest's metadata."""
    dev = resolve_device(device)
    ladder = tuple(ladder) if ladder is not None else default_ladder()
    extra = ckpt.manifest(step)["extra"]
    tmpl = {
        "state": D.state_template(int(extra["union_v"][-1]), dev),
        "frames": [D.state_template(int(v), dev)
                   for v in extra["union_v"][:-1]],
    }
    tree = ckpt.restore(tmpl, step, device=dev)
    by_name = {c.name: c for c in ladder}
    frames = []
    for k, fs in enumerate(tree["frames"]):
        frames.append(_Frame(state=fs, aux=prob.aux, is_local=prob.is_local))
        pg = part.compact_partition(
            pg, fs.status.cpu().numpy(), fs.w.cpu().numpy(),
            pad_to=extra["dims"][k],
        )
        prob = _build_level(pg, cfg, by_name.get(extra["path"][k + 1]["cell"]),
                            dev, plan_cache, tag="descent")
    return frames, pg, prob, tree["state"], extra


def solve_staged(
    g,
    p: int,
    algo: str,
    cfg: DisReduConfig = DisReduConfig(),
    *,
    ladder=None,
    plan_cache: Optional[E.PlanCache] = None,
    pad_to=None,
    window_cap: int = 16,
    common_cap: int = 4,
    edge_balanced: bool = True,
    ckpt=None,
    resume: bool = False,
    on_descent=None,
    trajectory: bool = False,
    pg: Optional[PartitionedGraph] = None,
    device: torch.device | str | None = None,
) -> Tuple[np.ndarray, dict]:
    """Staged solve with adaptive **shape descent** (kernel compaction).

    The solve runs in bounded *stages* (``cfg.descent_every`` rounds
    each); at every post-exchange stage boundary the alive kernel is
    measured (:func:`distributed.kernel_shape`) and, when it fits a
    smaller rung of the static shape `ladder` with hysteresis
    ``cfg.descent_factor``, the partition is *restricted* onto that cell
    (:func:`partition.compact_partition`), re-packed through
    ``engine.plan_for`` (descent plans hit the topology-keyed PlanCache,
    tagged in ``PlanCacheStats.descent_*``), and the solve continues at
    the smaller shape — so late rounds pay for the kernel, not the input.

    Bit-identity: compaction is an exact restriction (preserved ownership,
    window positions, gids), stage chunking visits the same states as the
    monolithic loops, and decisions stitch back through the per-level fold
    logs — members equal :func:`solve` on the same partition, bit for bit
    (for every algo/backend/schedule; descent off ⇒ literally one stage).

    ``ckpt`` (a :class:`repro_torch.distributed.checkpoint.
    CheckpointManager`) saves the frame stack + current state at every
    descent boundary; ``resume=True`` restores the latest boundary onto
    ``device`` and replays the deterministic compaction chain host-side
    before continuing.  ``on_descent(descents, cell_name)`` is the
    test/fault seam, called after each committed descent.  Solves on
    ``device`` (default CUDA).

    Returns ``(global member mask, stats)`` with stats keys: descents,
    path, kernel_ratio, alive_final, t_total, t_descend (host seconds
    spent measuring the kernel, compacting and re-packing) and stages
    (when ``trajectory``: phase, shape, L, rounds, alive, us per stage;
    with descent on also the host µs of the descent check after it,
    ``check_us``, the stage's ``kernel_shape`` as ``need``, and where it
    descended ``compact_us``, ``pack_us`` and the new plan's
    ``plan_slots``).
    """
    dev = resolve_device(device)
    ladder = tuple(ladder) if ladder is not None else default_ladder()
    t0 = time.perf_counter()
    if pg is None:
        pg = part.partition_graph(
            g, p, edge_balanced=edge_balanced, window_cap=window_cap,
            common_cap=common_cap, pad_to=pad_to,
        )
    n = pg.n_global
    frames: list = []
    path = [dict(cell="input", L=int(pg.L), E=int(pg.E))]
    descents = 0
    stages: list = []
    min_ratio = 1.0
    budget = cfg.max_rounds
    t_descend = 0.0

    def _build(pg_, cell=None, tag=None):
        return _build_level(pg_, cfg, cell, dev, plan_cache, tag)

    prob = _build(pg)
    state = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    phase = "greedy" if algo == "greedy" else "reduce"

    if resume and ckpt is not None and ckpt.latest_step() is not None:
        frames, pg, prob, state, extra = restore_staged(
            ckpt, pg, prob, cfg, ladder=ladder, plan_cache=plan_cache,
            device=dev)
        phase = extra["phase"]
        budget = int(extra["budget"])
        descents = int(extra["descents"])
        path = list(extra["path"])
        min_ratio = float(extra["min_ratio"])

    def _alive() -> int:
        return int(((state.status == UNDECIDED) & prob.is_local).sum())

    def _save(cur_phase: str, cur_budget: int) -> None:
        if ckpt is None:
            return
        tree = {"state": state, "frames": [f.state for f in frames]}
        extra = dict(
            kind="solve_staged", phase=cur_phase, budget=int(cur_budget),
            descents=descents, path=path, min_ratio=min_ratio,
            union_v=[int(f.state.w.shape[0]) for f in frames]
                    + [int(state.w.shape[0])],
            dims=[{k: int(e[k]) for k in ("L", "E", "G", "B", "S")}
                  for e in path[1:]],
        )
        ckpt.save(descents, tree, extra=extra)

    def _run_stage(phase_name: str, iters: int):
        nonlocal state
        t = time.perf_counter()
        state, rounds, flag = _stage_union(state, prob, cfg, phase_name,
                                           int(iters))
        if trajectory:
            alive = _alive()   # reads the device, so the stage is done
            stages.append(dict(
                phase=phase_name, shape=path[-1]["cell"], L=int(pg.L),
                rounds=int(rounds), alive=alive,
                us=round((time.perf_counter() - t) * 1e6, 1),
            ))
        return int(rounds), bool(flag)

    def _maybe_descend(cur_phase: str, cur_budget: int) -> None:
        nonlocal pg, prob, state, descents, min_ratio, t_descend
        if not cfg.descent:
            return
        t0 = time.perf_counter()
        status = state.status.cpu().numpy()
        alive = int(((status == UNDECIDED)
                     & prob.is_local.cpu().numpy()).sum())
        rec = stages[-1] if trajectory else {}
        cell = None
        if alive:
            min_ratio = min(min_ratio, alive / max(n, 1))
            rec["need"] = need = D.kernel_shape(pg, status)
            cell = _pick_cell(ladder, need, pg.L, pg.E, cfg.descent_factor)
            if cell is not None and not D.ghosts_consistent(pg, status):
                cell = None
        t1 = time.perf_counter()
        rec["check_us"] = round((t1 - t0) * 1e6, 1)
        if cell is None:
            t_descend += t1 - t0
            return
        frames.append(_Frame(state=state, aux=prob.aux,
                             is_local=prob.is_local))
        pg = part.compact_partition(
            pg, status, state.w.cpu().numpy(),
            pad_to=dict(L=cell.L, E=cell.E, G=cell.G, B=cell.B, S=cell.S),
        )
        t2 = time.perf_counter()
        prob = _build(pg, cell, tag="descent")
        state = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
        t3 = time.perf_counter()
        descents += 1
        path.append(dict(cell=cell.name, L=int(pg.L), E=int(pg.E),
                         G=int(pg.G), B=int(pg.B), S=int(pg.S)))
        t_descend += t3 - t0
        rec.update(compact_us=round((t2 - t1) * 1e6, 1),
                   pack_us=round((t3 - t2) * 1e6, 1),
                   plan_slots=0 if prob.plan is None
                   else prob.plan.edge_perm.numel())
        _save(cur_phase, cur_budget)
        if on_descent is not None:
            on_descent(descents, cell.name)

    def _reduce_phase(left: int) -> int:
        while left > 0:
            iters = min(cfg.descent_every, left) if cfg.descent else left
            rounds, changed = _run_stage("reduce", iters)
            left -= rounds
            _maybe_descend("reduce", left)
            if not changed:
                break
        return left

    def _greedy_phase() -> None:
        while _alive():
            iters = cfg.descent_every if cfg.descent else 100_000
            _, remaining = _run_stage("greedy", iters)
            _maybe_descend("greedy", 0)
            if not remaining:
                break

    if algo == "reduce":
        if phase == "reduce":
            budget = _reduce_phase(budget)
    elif algo == "greedy":
        _greedy_phase()
    elif algo == "rg":
        if phase == "reduce":
            budget = _reduce_phase(budget)
            phase = "greedy"
        _greedy_phase()
    elif algo == "rnp":
        while _alive():
            _reduce_phase(budget)
            budget = cfg.max_rounds
            if not _alive():
                break
            _run_stage("peel", 1)
    else:
        raise ValueError(f"unknown algo {algo!r}")

    # ---- stitch: reconstruct innermost-out through the frame stack ---- #
    def _members_at(state_, aux_, is_local_) -> np.ndarray:
        in_set = R.reconstruct_members(state_, aux_).cpu().numpy()
        members = np.zeros(n, dtype=bool)
        sel = in_set & is_local_.cpu().numpy()
        members[aux_.gid.cpu().numpy()[sel]] = True
        return members

    members = _members_at(state, prob.aux, prob.is_local)
    for fr in reversed(frames):
        status = fr.state.status.cpu().numpy().copy()
        gids = fr.aux.gid.cpu().numpy()
        member_of_gid = np.zeros(n + 1, dtype=bool)
        member_of_gid[:n] = members
        und = status == UNDECIDED
        decided_in = member_of_gid[np.where(gids >= 0, gids, n)] & und
        status[und] = EXCLUDED
        status[decided_in] = INCLUDED
        st2 = fr.state._replace(status=torch.from_numpy(status).to(dev))
        members = _members_at(st2, fr.aux, fr.is_local)

    stats = dict(
        descents=descents, path=path, kernel_ratio=min_ratio,
        alive_final=_alive(), t_total=time.perf_counter() - t0,
        t_descend=t_descend,
    )
    if trajectory:
        stats["stages"] = stages
    return members, stats
