"""DisReduS / DisReduA — the paper's distributed reduction algorithms (§5).

Port of :mod:`repro.core.distributed`.  Round structure (Algorithm 5.1):

  while global reduction progress:
      LocalReduce(G_i)            — §5.1, vectorized rule sweeps to fixpoint
      ExchWeightUpdates + ExchStatusUpdates — one fused halo exchange

DisReduA (§5.4) is bounded staleness: each PE exchanges after
``stale_sweeps`` rule sweeps instead of waiting for its local fixpoint.

Two execution paths share all rule and exchange code:

  * union path — all PEs stacked into one block-diagonal graph on one
    device (:func:`disredu_union`);
  * per-PE path — one rank of a ``torch.distributed`` process group a PE
    (the reference's shard_map path; "mesh" there is a process group
    here), boards exchanged by collectives (:func:`disredu_shard_map_fn`;
    ranks are started by :mod:`repro_torch.launch.mesh`).

Each round loop is a host loop over a device change flag (on the per-PE
path, its OR over the ranks), with the reference ``lax.while_loop``'s trip
count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as E
from repro_torch.core import exchange as X
from repro_torch.core import rules as R
from repro_torch.core.local_reduce import local_reduce
from repro_torch.core.partition import PartitionedGraph

UNDECIDED, INCLUDED, EXCLUDED, FOLDED = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class DisReduConfig:
    heavy_k: int = 8
    use_heavy: bool = True
    mode: str = "sync"            # "sync" = DisReduS | "async" = DisReduA
    stale_sweeps: int = 2         # async: sweeps between exchanges
    exchange: str = "allgather"   # "allgather" | "a2a"  (per-PE path)
    schedule: str = "cheap"       # named rule schedule (engine.SCHEDULES)
    backend: str = "torch"        # aggregate backend: torch | blocked | cuda
    max_rounds: int = 10_000
    r_blk: Optional[int] = None   # blocked-ELL row-block height; None =
                                  # autotune at plan-build time (engine)
    # --- shape-descent policy (solvers.solve_staged) ------------------- #
    descent: bool = False         # re-pack the alive kernel onto smaller
                                  # ladder cells at stage boundaries
    descent_every: int = 2        # rounds (reduce/greedy) per stage between
                                  # descent checks
    descent_factor: int = 2       # hysteresis: only descend onto a cell
                                  # with cell.L * factor <= current L

    @property
    def sweeps_per_round(self) -> int:
        return 1_000_000 if self.mode == "sync" else self.stale_sweeps


class UnionProblem(NamedTuple):
    w0: torch.Tensor
    is_local: torch.Tensor
    is_ghost: torch.Tensor
    aux: R.Aux
    halo: X.Halo
    p: int
    V: int  # per-PE vertex count (union total = p * V)
    plan: Optional[E.SegPlan] = None  # blocked-ELL packing (non-torch backends)


def build_union_problem(
    pg: PartitionedGraph, backend: str = "torch",
    r_blk: Optional[int] = None,
    device: torch.device | str | None = None,
    plan_cache: Optional[E.PlanCache] = None,
    plan_tag: Optional[str] = None,
) -> UnionProblem:
    """Stack all PEs into one block-diagonal graph with offset indices, on
    ``device`` (default CUDA).

    ``plan_cache`` (an :class:`~repro_torch.core.engine.PlanCache`) reuses
    the blocked-ELL SegPlan whenever the union topology repeats;
    ``plan_tag="descent"`` counts the lookup in the cache's descent
    counters (the staged solver's re-packs)."""
    dev = resolve_device(device)
    p, V = pg.p, pg.V
    off_v = (np.arange(p, dtype=np.int64) * V)[:, None]

    def offset_idx(a: np.ndarray) -> np.ndarray:
        # per-PE local indices -> union indices (nil_i = i*V + nil)
        return (a.astype(np.int64)
                + off_v.reshape((p,) + (1,) * (a.ndim - 1))).astype(np.int32)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    row = offset_idx(pg.row).reshape(-1)
    col = offset_idx(pg.col).reshape(-1)
    window = offset_idx(pg.window).reshape(p * V, -1)
    edge_common = offset_idx(pg.edge_common).reshape(row.shape[0], -1)
    win_adj_bits = pg.win_adj_bits.reshape(p * V, -1)
    gid = pg.gid.reshape(-1)
    aux = R.Aux(
        row=t(row), col=t(col), gid=t(gid),
        is_local=t(pg.is_local.reshape(-1)),
        is_iface=t(pg.is_iface.reshape(-1)),
        owner_rank=t(pg.owner_pe.reshape(-1)),
        window=t(window),
        win_complete=t(pg.win_complete.reshape(-1)),
        win_adj_bits=t(win_adj_bits),
        edge_common=t(edge_common),
    )
    plan = None if backend == "torch" else E.plan_for(
        plan_cache, row, p * V, r_blk=r_blk, col=col, gid=gid,
        window=window, win_adj_bits=win_adj_bits, tag=plan_tag, device=dev,
    )
    return UnionProblem(
        w0=t(pg.w0.reshape(-1)),
        is_local=aux.is_local,
        is_ghost=t(pg.is_ghost.reshape(-1)),
        aux=aux, halo=X.make_halo(pg, dev), p=p, V=V, plan=plan,
    )


def stack_problems(probs: Sequence[UnionProblem],
                   e_blk: Optional[int] = None) -> UnionProblem:
    """B single-PE problems of one serve cell → one p=B union problem.

    The union layout is already a batch axis: PE b owns the block of V
    slots [b*V, (b+1)*V) with its own nil slot, and no edge, window or
    common-neighbourhood entry leaves its block, so the B instances are
    solved side by side by the union path with no halo traffic between
    them.  Vertex indices (``row``, ``col``, ``window``, ``edge_common``,
    the halo's ghost vertices and board slots) shift by ``b*V``; the
    halo's board padding, ``V`` for one PE, becomes the union's ``B*V``;
    ghost owners point at the instance's own board.  ``gid`` and
    ``owner_rank`` stay per instance (p=1 has no ghosts, so the rank
    tie-break never fires).  The plans stack with
    :func:`~repro_torch.core.engine.stack_plans` (``e_blk`` = shared edge
    budget).  All tensors stay on the problems' device."""
    if not probs:
        raise ValueError("stack_problems needs at least one problem")
    V = probs[0].V
    if any(p.p != 1 or p.V != V for p in probs):
        raise ValueError("stack_problems takes single-PE problems of one "
                         "shape")
    if any((p.plan is None) != (probs[0].plan is None) for p in probs):
        raise ValueError("stack_problems needs plans on all or none")
    B = len(probs)
    dev = probs[0].w0.device
    off = torch.arange(B, dtype=torch.int32, device=dev) * V

    def cat(get):
        return torch.cat([get(p) for p in probs])

    def shifted(get):
        # stack [B, ...], offset instance b by b*V, flatten the batch
        x = torch.stack([get(p) for p in probs])
        x = x + off.view((B,) + (1,) * (x.dim() - 1))
        return x.reshape((-1,) + tuple(x.shape[2:]))

    aux = R.Aux(
        row=shifted(lambda p: p.aux.row), col=shifted(lambda p: p.aux.col),
        gid=cat(lambda p: p.aux.gid), is_local=cat(lambda p: p.aux.is_local),
        is_iface=cat(lambda p: p.aux.is_iface),
        owner_rank=cat(lambda p: p.aux.owner_rank),
        window=shifted(lambda p: p.aux.window),
        win_complete=cat(lambda p: p.aux.win_complete),
        win_adj_bits=cat(lambda p: p.aux.win_adj_bits),
        edge_common=shifted(lambda p: p.aux.edge_common),
    )
    h = [p.halo for p in probs]
    iface = torch.cat([x.iface_slots for x in h])          # [B, Bs], pad V
    iface = torch.where(iface < V, iface + off[:, None], B * V)
    n_board, n_ghost = iface.shape[1], h[0].ghost_vertex.shape[1]

    def block_diag(get, fill):
        # [1, 1, S] per instance → [B, B, S], no traffic off the diagonal
        diag = torch.cat([get(x)[0] for x in h])            # [B, S]
        out = torch.full((B, B, diag.shape[-1]), fill, dtype=diag.dtype,
                         device=dev)
        pes = torch.arange(B, device=dev)
        out[pes, pes] = diag
        return out

    halo = X.Halo(
        iface_slots=iface,
        ghost_vertex=torch.cat([x.ghost_vertex for x in h]) + off[:, None],
        ghost_owner_pe=torch.cat([x.ghost_owner_pe for x in h])
        + torch.arange(B, dtype=torch.int32, device=dev)[:, None],
        ghost_owner_slot=torch.cat([x.ghost_owner_slot for x in h]),
        ghost_valid=torch.cat([x.ghost_valid for x in h]),
        send_slot=block_diag(lambda x: x.send_slot, n_board),
        recv_ghost=block_diag(lambda x: x.recv_ghost, n_ghost),
    )
    plan = None
    if probs[0].plan is not None:
        plan = E.stack_plans([p.plan for p in probs], e_blk=e_blk)
    return UnionProblem(
        w0=cat(lambda p: p.w0), is_local=aux.is_local,
        is_ghost=cat(lambda p: p.is_ghost), aux=aux, halo=halo, p=B, V=V,
        plan=plan,
    )


# --------------------------------------------------------------------- #
# the DisRedu round loop, and the union path (single-device simulation)
# --------------------------------------------------------------------- #
def reduce_rounds(state, aux, exchange, gany, cfg: DisReduConfig,
                  plan=None, max_rounds: Optional[int] = None):
    """DisRedu rounds until one changes nothing anywhere or ``max_rounds``
    (default ``cfg.max_rounds``) have run; returns (state, rounds,
    changed_last).  A round is ``local_reduce`` to ``cfg.sweeps_per_round``
    sweeps, then ``exchange(state) -> (state, changed)``; ``gany`` reads a
    round's change flag on the host: ``bool`` on the union path, the OR
    over the ranks on the per-PE path (the reference's ``psum``), once a
    round.  The sweeps inside a round read each PE's own flag on the
    per-PE path (the reference's ``local_reduce`` is rank-local), so a PE
    that went quiet runs heavy vertex and stops sweeping on its own.
    ``changed`` starts True and is tested before each round, as the
    reference's ``while_loop`` cond is."""
    limit = cfg.max_rounds if max_rounds is None else max_rounds
    rounds, changed = 0, True
    while changed and rounds < limit:
        snap_s, snap_w = state.status, state.w
        state = local_reduce(
            state, aux, heavy_k=cfg.heavy_k, use_heavy=cfg.use_heavy,
            max_sweeps=cfg.sweeps_per_round, schedule=cfg.schedule,
            backend=cfg.backend, plan=plan,
        )
        state, _ = exchange(state)
        changed = gany((state.status != snap_s).any()
                       | (state.w != snap_w).any())
        rounds += 1
    return state, rounds, changed


def disredu_union(prob: UnionProblem,
                  cfg: DisReduConfig) -> Tuple[R.RedState, int]:
    """DisRedu rounds from the initial state until no round changes
    anything (or ``cfg.max_rounds``); returns (state, rounds)."""
    def exchange(state):
        return X.exchange_union(state, prob.aux, prob.halo,
                                backend=cfg.backend, plan=prob.plan)

    state = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    state, rounds, _ = reduce_rounds(state, prob.aux, exchange, bool, cfg,
                                     plan=prob.plan)
    return state, rounds


def disredu(
    pg: PartitionedGraph, cfg: DisReduConfig = DisReduConfig(),
    device: torch.device | str | None = None,
) -> Tuple[R.RedState, UnionProblem, int]:
    """Run DisReduS/DisReduA on the union simulation path."""
    prob = build_union_problem(pg, cfg.backend, cfg.r_blk, device)
    state, rounds = disredu_union(prob, cfg)
    return state, prob, rounds


# --------------------------------------------------------------------- #
# per-PE path (one rank of a torch.distributed process group a PE)
# --------------------------------------------------------------------- #
def shard_map_arrays(pg: PartitionedGraph,
                     cfg: DisReduConfig) -> Dict[str, np.ndarray]:
    """The stacked [p, ...] host arrays the per-PE path consumes (the
    reference's keys): the partitioned graph plus, for the blocked
    backends, the per-PE blocked-ELL plan packed host-side with a shared
    E_BLK (:func:`~repro_torch.core.engine.build_plan_stacked`).  Rank i
    takes row i of each (:func:`_unpack_per_pe`)."""
    arrs = dict(pg.device_arrays())
    if cfg.backend != "torch":
        plan = E.build_plan_stacked(
            pg.row, pg.V, r_blk=cfg.r_blk,
            cols=pg.col, gids=pg.gid, windows=pg.window,
            win_adj_bits=pg.win_adj_bits,
        )
        arrs["plan_perm"] = plan.edge_perm.numpy()
        arrs["plan_lrow"] = plan.lrow.numpy()
        arrs["plan_wbits"] = plan.wbits.numpy()
        arrs["plan_wnh"] = plan.wnh.numpy()
        # the row-block height as a zero-size axis, as the reference keeps it
        arrs["plan_rblk"] = np.zeros((pg.p, plan.r_blk, 0), dtype=np.int32)
    return arrs


def _unpack_per_pe(a: Dict[str, np.ndarray], device: torch.device | str):
    """One PE's row of :func:`shard_map_arrays` → ``(aux, halo, plan,
    tensors)`` on ``device``.  The halo takes the per-PE layout: ghosts are
    slots ``L .. L+G-1`` (``V = L + G + 1``), a ghost's owner is clamped to
    rank 0 on padding, ``send_slot`` pads to board slot B and
    ``recv_ghost`` to scratch slot G."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in a.items()}
    G = a["ghost_owner_slot"].shape[0]
    L = a["w0"].shape[0] - G - 1
    aux = R.Aux(
        row=t["row"], col=t["col"], gid=t["gid"], is_local=t["is_local"],
        is_iface=t["is_iface"], owner_rank=t["owner_pe"],
        window=t["window"], win_complete=t["win_complete"],
        win_adj_bits=t["win_adj_bits"], edge_common=t["edge_common"],
    )
    halo = X.Halo(
        iface_slots=t["iface_slots"],
        ghost_vertex=L + torch.arange(G, dtype=torch.int32, device=device),
        ghost_owner_pe=t["owner_pe"][L : L + G].clamp(min=0),
        ghost_owner_slot=t["ghost_owner_slot"],
        ghost_valid=t["is_ghost"][L : L + G],
        send_slot=t["send_slot"], recv_ghost=t["recv_ghost"],
    )
    plan = None
    if "plan_perm" in a:
        r_blk = a["plan_rblk"].shape[0]
        plan = E.SegPlan(
            edge_perm=t["plan_perm"], lrow=t["plan_lrow"], r_blk=r_blk,
            extent=E.live_extent(t["plan_lrow"], r_blk),
            wbits=t["plan_wbits"], wnh=t["plan_wnh"],
        )
    return aux, halo, plan, t


def disredu_shard_map_fn(
    a: Dict[str, np.ndarray], cfg: DisReduConfig, *, group=None,
    device: torch.device | str | None = None,
) -> Tuple[R.RedState, int]:
    """DisRedu rounds on this rank's PE; returns (state, rounds).

    ``a`` is this rank's row of :func:`shard_map_arrays`; ``group`` is the
    process group of the PEs (the reference's shard_map mesh; default: the
    default group), one rank a PE.  The rounds are :func:`reduce_rounds`'
    with :func:`~repro_torch.core.exchange.exchange_shmap` by
    ``cfg.exchange`` and the round's change flag ORed over the group
    (``all_reduce``, read on the host as the union loop reads its flag), so
    every rank stops in the same round.  The sweeps are rank-local, as the
    reference's are: a PE whose cheap rules go quiet runs heavy vertex
    while the union path's global flag still holds it back, so the rounds
    and, on some instances, the reduced graph differ from the union
    path's, as the reference's own shard_map's do.  The reference returns
    the shard_map'd function; here each rank calls this directly."""
    dev = resolve_device(device)
    aux, halo, plan, t = _unpack_per_pe(a, dev)

    def exchange(state):
        return X.exchange_shmap(state, aux, halo, group=group,
                                method=cfg.exchange, backend=cfg.backend,
                                plan=plan)

    state = R.init_state(t["w0"], t["is_local"], t["is_ghost"])
    state, rounds, _ = reduce_rounds(
        state, aux, exchange, lambda flag: X.global_any(flag, group), cfg,
        plan=plan)
    return state, rounds


# --------------------------------------------------------------------- #
# result extraction
# --------------------------------------------------------------------- #
def kernel_stats(
    pg: PartitionedGraph, state: R.RedState
) -> Tuple[int, int]:
    """(#alive vertices, #alive undirected edges) of the reduced graph."""
    status = state.status.cpu().numpy()
    is_local = np.asarray(pg.is_local.reshape(-1))
    alive_v = int(((status == UNDECIDED) & is_local).sum())
    row = np.asarray(pg.row).astype(np.int64)
    col = np.asarray(pg.col).astype(np.int64)
    off = (np.arange(pg.p, dtype=np.int64) * pg.V)[:, None]
    ur, uc = (row + off).reshape(-1), (col + off).reshape(-1)
    ea = (status[ur] == UNDECIDED) & (status[uc] == UNDECIDED)
    # count each undirected edge once: local rows only, and only (u < v) by gid
    gids = np.asarray(pg.gid.reshape(-1))
    cnt = int((ea & is_local[ur] & (gids[ur] < gids[uc])).sum())
    return alive_v, cnt


def kernel_shape(pg: PartitionedGraph, status: np.ndarray) -> dict:
    """Exact per-PE padded-size requirements of the alive kernel.

    Returns the smallest L/G/E/B/S a :func:`partition.compact_partition`
    restriction of ``pg`` at this state needs (maxima over PEs, before any
    ladder-cell flooring).  This is the stage-boundary measurement the
    shape-descent policy compares against the static cell ladder.
    """
    p, V = pg.p, pg.V
    status = np.asarray(status).reshape(p, V)
    alive = status == UNDECIDED
    keep_l = pg.is_local & alive
    keep_g = pg.is_ghost & alive
    keep = keep_l | keep_g
    nl = ng = ne = nb = ns = 0
    for i in range(p):
        nl = max(nl, int(keep_l[i].sum()))
        ng = max(ng, int(keep_g[i].sum()))
        ne = max(ne, int((keep[i][pg.row[i]] & keep[i][pg.col[i]]).sum()))
        nb = max(nb, int((keep_l[i] & pg.is_iface[i]).sum()))
        gk = np.flatnonzero(keep_g[i])
        if gk.size:
            owners = pg.owner_pe[i, gk]
            ns = max(ns, int(np.bincount(owners[owners >= 0]).max()))
    return dict(L=nl, G=ng, E=ne, B=nb, S=ns)


def ghosts_consistent(pg: PartitionedGraph, status: np.ndarray) -> bool:
    """True iff every valid ghost slot is alive exactly when its owner's
    local copy is alive — the exchange-consistency precondition of
    :func:`partition.compact_partition`.  Holds at every post-exchange
    round boundary; transiently false between a peel and the next
    exchange (the staged solver never descends there)."""
    p, V = pg.p, pg.V
    status = np.asarray(status).reshape(p, V)
    alive = status == UNDECIDED
    owner_alive = np.zeros(pg.n_global, dtype=bool)
    for i in range(p):
        loc = pg.is_local[i]
        owner_alive[pg.gid[i][loc]] = alive[i][loc]
    for i in range(p):
        gh = pg.is_ghost[i]
        if (alive[i][gh] != owner_alive[pg.gid[i][gh]]).any():
            return False
    return True


def state_template(union_v: int,
                   device: torch.device | str = "cpu") -> R.RedState:
    """A zero :class:`RedState` on ``device`` with the union-layout shapes
    for ``p*V = union_v`` slots — the restore template for checkpointed
    stage states (shape-descent checkpoints store one state per descent
    level, each at its own ladder shape; the level's V is recorded in the
    checkpoint manifest)."""
    z = torch.zeros(union_v, dtype=torch.int32, device=device)
    f = torch.zeros(union_v, dtype=torch.bool, device=device)
    return R.init_state(z, f, f)


def members_global(
    pg: PartitionedGraph, state: R.RedState, aux: R.Aux
) -> np.ndarray:
    """Reconstruct and assemble the global member mask (union layout)."""
    in_set = R.reconstruct_members(state, aux).cpu().numpy()
    members = np.zeros(pg.n_global, dtype=bool)
    is_local = np.asarray(pg.is_local.reshape(-1))
    gids = np.asarray(pg.gid.reshape(-1))
    members[gids[in_set & is_local]] = True
    return members


def members_global_per_pe(pg: PartitionedGraph,
                          members: np.ndarray) -> np.ndarray:
    """[n_global] bool member mask from per-PE memberships [p, V]."""
    glob = np.zeros(pg.n_global, dtype=bool)
    sel = members & pg.is_local
    glob[pg.gid[sel]] = True
    return glob
