"""MWIS-as-a-service on one card: batched many-instance solving.

Port of :mod:`repro.core.serve`, whose docstring gives the design: shape
bucketing into the static ``kind="serve"`` cells (smallest cell with
``L >= n`` and ``E >= 2m`` wins), a topology-keyed
:class:`~repro_torch.core.engine.PlanCache` so a repeated topology with
fresh weights skips all host packing, admission through
:func:`~repro_torch.core.validate.canonicalize`, per-request fault
isolation with stable reason codes, the backend fallback chain
(``blocked → torch``: bit-identical backends, so a demotion costs speed
only; counted in ``stats["fallbacks"]`` and logged in ``events``, and
never leaving the service's device), and verified outputs.

What differs from the reference:

  * **batching** — the reference vmaps its single-instance program;
    ``torch.func.vmap`` cannot batch the port's host loops.  A
    chunk of B same-cell requests is instead stacked into ONE union
    problem with p = B (:func:`repro_torch.core.distributed.
    stack_problems`: each instance a PE, no halo traffic) and solved by
    the existing union path (:func:`repro_torch.core.solvers.
    solve_union_arrays`).  Every op is int32 and every round body is
    idempotent at its fixpoint, so each instance gets the single-instance
    result bit for bit.  On the ``cuda`` backend every aggregate of the
    chunk is one launch of the ``segment_fused`` kernel over the stacked
    plan (one grid row per instance).
  * **one card, no pipeline** — ``devices > 1`` (the serve mesh) and
    ``pipeline=True`` (the double-buffered chunk pipeline; both ROADMAP
    Queue 1 item 4) raise :class:`NotImplementedError`.
    ``ServeConfig.pipeline`` therefore defaults to False here: chunks run
    one after another.
  * **shape descent** — ``descent="auto"`` is the reference's: requests
    whose cell has ``L >= descent_min_L`` are solved one at a time by the
    staged solver (:func:`repro_torch.core.solvers.solve_staged`), and
    instances too large for every serve cell enter through the
    ``kind="descent"`` cells.  Their descent plans share the topology
    cache (``cache_descent_*``).
  * **no fallback from the kernel** — the reference demotes ``pallas``
    to ``blocked``; here ``cuda`` has no fallback, so a ``segment_fused``
    kernel that fails to build or launch turns the chunk's requests into
    ``REASON_BACKEND_FAILED`` results instead of running the plain
    version on the card.
  * **device** — cached problems live on ``ServeConfig.device`` (default
    ``cuda``; without a visible GPU the service refuses to start unless
    ``device="cpu"``); a chunk's weight planes go host→device in one copy.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import mwis as CFG
from repro_torch.core import distributed as D
from repro_torch.core import engine as E
from repro_torch.core import solvers as SOL
from repro_torch.core import validate as V
from repro_torch.core.graph import Graph
from repro_torch.core.partition import partition_graph

#: Backend degradation order: a failing backend falls to the next entry.
#: ``cuda`` (the hand-written kernel) has none: its failure is an error.
FALLBACK_CHAIN = {
    "cuda": ("cuda",),
    "blocked": ("blocked", "torch"),
    "torch": ("torch",),
}


class ServeCell(NamedTuple):
    """One resolved serving bucket (a kind="serve" MWIS_SHAPES row): the
    reference's fields without its multi-device knobs (``serve_devices``,
    ``pipeline``; ROADMAP Queue 1 item 4)."""

    name: str
    L: int      # max vertices
    E: int      # max directed edges (2m)
    G: int      # ghost pad (p=1: floor only)
    B: int      # board pad
    S: int      # send-list pad
    D: int      # window cap
    Dc: int     # common-neighborhood cap
    schedule: str
    r_blk: int  # blocked-ELL row-block height (shared across the cell)
    e_blk: int  # blocked-ELL edge-budget floor (high-water mark seed)


def _cells_of_kind(kind: str) -> Tuple[ServeCell, ...]:
    cells = []
    for name, meta in CFG.MWIS_SHAPES.items():
        if meta.get("kind") != kind:
            continue
        seg = meta.get("seg_blk", {})
        cells.append(ServeCell(
            name=name, L=meta["L"], E=meta["E"], G=meta["G"], B=meta["B"],
            S=meta["S"], D=meta["D"], Dc=meta["Dc"],
            schedule=meta.get("schedule", "cheap-fused"),
            r_blk=seg.get("r_blk", E.R_BLK),
            e_blk=seg.get("e_blk", E.E_BLK_MULTIPLE),
        ))
    cells.sort(key=lambda c: (c.L, c.E))
    return tuple(cells)


def serve_cells() -> Tuple[ServeCell, ...]:
    """The bucket table, ascending by capacity."""
    return _cells_of_kind("serve")


def descent_entry_cells() -> Tuple[ServeCell, ...]:
    """kind="descent" MWIS_SHAPES rows — oversize *entry* shapes for the
    staged path (never batched; a solve entering here descends into the
    serve cells as the kernel shrinks)."""
    return _cells_of_kind("descent")


def bucket_for(n: int, directed_edges: int,
               cells: Optional[Sequence[ServeCell]] = None) -> ServeCell:
    """Smallest cell admitting an instance with n vertices / 2m directed
    edges; raises ValueError (naming the limits) when none fits."""
    cells = tuple(cells) if cells is not None else serve_cells()
    for c in cells:
        if n <= c.L and directed_edges <= c.E:
            return c
    big = cells[-1] if cells else None
    raise ValueError(
        f"instance (n={n}, directed_edges={directed_edges}) exceeds every "
        f"serve cell; largest is "
        f"{big.name if big else '<none>'} "
        f"(L={big.L if big else 0}, E={big.E if big else 0}) — route giant "
        f"instances through the distributed path "
        f"(repro_torch.core.solvers.solve)"
    )


class Topology(NamedTuple):
    """Cached per-topology artifact: everything derived from the edge list.

    ``prob`` is a p=1 UnionProblem on the service's device whose w0 is a
    placeholder; ``n`` is the true (unpadded) vertex count.  A request
    carries its own weight plane in ``w0`` (host, int32 [L+G+1]); the
    cached entry has none."""

    prob: D.UnionProblem
    n: int
    w0: Optional[np.ndarray] = None


def _pack_topology(g: Graph, cell: ServeCell, backend: str,
                   device: torch.device) -> Topology:
    pg = partition_graph(
        g, 1, window_cap=cell.D, common_cap=cell.Dc,
        pad_to=dict(L=cell.L, G=cell.G, E=cell.E, B=cell.B, S=cell.S),
    )
    if pg.L != cell.L or pg.E != cell.E or pg.G != cell.G:
        raise ValueError(
            f"instance broke out of cell {cell.name}: padded "
            f"(L={pg.L}, E={pg.E}, G={pg.G}) vs cell "
            f"(L={cell.L}, E={cell.E}, G={cell.G})"
        )
    prob = D.build_union_problem(
        pg, backend, None if backend == "torch" else cell.r_blk, device
    )
    return Topology(prob=prob, n=g.n)


def _weight_plane(g: Graph, cell: ServeCell) -> np.ndarray:
    w0 = np.zeros(cell.L + cell.G + 1, dtype=np.int32)
    w0[: g.n] = g.weights
    return w0


class ServeResult(NamedTuple):
    """One request's outcome.  ``ok=False`` results carry a stable
    ``reason`` code (:mod:`repro_torch.core.validate` REASON_*) and a
    human-readable ``error``; their mask is all-False and weight 0.
    ``reason="oversize"`` means the instance exceeds every serve cell (and,
    with ``descent="auto"``, every descent entry cell) — route it through
    the distributed path, ``repro_torch.core.solvers.solve``."""

    members: np.ndarray   # [n] bool — the independent set
    weight: int           # its weight under the request's weight vector
    ok: bool = True
    reason: Optional[str] = None   # machine-readable error code
    error: Optional[str] = None    # human-readable detail


def _error_result(n: int, reason: str, detail: str) -> ServeResult:
    return ServeResult(
        members=np.zeros(max(n, 0), dtype=bool), weight=0,
        ok=False, reason=reason, error=f"{reason}: {detail}",
    )


def _backend_failed(n: int, backend: str, err: Exception) -> ServeResult:
    return _error_result(
        n, V.REASON_BACKEND_FAILED,
        f"backend {backend!r} failed with no fallback left: {err}")


class _Staged(NamedTuple):
    """A chunk stacked into one union problem on the device, ready to
    solve."""

    cell: ServeCell
    backend: str
    topos: Tuple[Topology, ...]   # the real (unpadded) chunk members
    prob: D.UnionProblem          # p = static batch size
    e_blk: int
    rec: dict                     # per-chunk stage-timing record


class _Inflight(NamedTuple):
    """A solved chunk whose members are still on the device."""

    staged: _Staged
    members: torch.Tensor         # [bt, L+G+1] bool
    t_dispatch: float


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (algo/backend/schedule as in DisReduConfig).

    ``devices`` (a serve mesh) and ``pipeline`` (the overlapped chunk
    pipeline) are the reference's knobs for work not ported yet (ROADMAP
    Queue 1 item 4): any value but the one-card, synchronous setting
    raises at construction of the service."""

    algo: str = "rg"              # greedy | rg | rnp
    backend: str = "torch"        # torch | blocked | cuda
    schedule: Optional[str] = None  # None -> per-cell default
    heavy_k: int = 8
    use_heavy: bool = True
    max_rounds: int = 64
    cache_entries: int = 256      # topology-cache bound (LRU)
    max_batch: int = 64           # largest admitted device batch
    validate: bool = True         # canonicalize/reject requests on admission
    verify: str = "off"           # post-solve audit: off | sample | full
    devices: Optional[int] = None  # serve-mesh size: None or 1 (one card)
    pipeline: bool = False        # overlapped chunk pipeline: not ported
    # --- shape descent (solvers.solve_staged) ------------------------- #
    descent: str = "off"          # off | auto — big cells take the staged
                                  # path and shrink mid-solve
    descent_min_L: int = 1024     # smallest cell L routed through descent
                                  # (default: serve_m and up)
    descent_every: int = 2        # stage length between descent checks
    device: str = "cuda"          # torch device the service solves on


class MWISService:
    """Bucketing → plan cache → stacked union solve.

    ``solve_batch`` groups requests by serve cell, pads each group to a
    static batch size (:data:`repro_torch.configs.mwis.
    MWIS_SERVE_BATCH_SIZES`, phantom repeat-last instances, as the
    reference does) and solves each (cell, ≤ max_batch) chunk as one
    stacked problem.  Results come back in request order.
    """

    def __init__(self, cfg: ServeConfig = ServeConfig(),
                 cells: Optional[Sequence[ServeCell]] = None):
        if cfg.algo not in ("greedy", "rg", "rnp"):
            raise ValueError(f"unknown serve algo {cfg.algo!r}")
        if cfg.backend not in E.BACKENDS:
            raise ValueError(
                f"unknown backend {cfg.backend!r}; available: {E.BACKENDS}"
            )
        if cfg.verify not in ("off", "sample", "full"):
            raise ValueError(
                f"unknown verify mode {cfg.verify!r}; "
                "available: ('off', 'sample', 'full')"
            )
        if cfg.descent not in ("off", "auto"):
            raise ValueError(
                f"unknown descent mode {cfg.descent!r}; "
                "available: ('off', 'auto')"
            )
        if cfg.devices is not None and cfg.devices < 1:
            raise ValueError(f"serve devices={cfg.devices} must be >= 1")
        if cfg.devices is not None and cfg.devices > 1:
            raise NotImplementedError(
                f"devices={cfg.devices}: the multi-GPU serve mesh is "
                "ROADMAP Queue 1 item 4; the port serves on one card")
        if cfg.pipeline:
            raise NotImplementedError(
                "pipeline=True: the overlapped chunk pipeline is ROADMAP "
                "Queue 1 item 4; chunks run synchronously")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.cells = tuple(cells) if cells is not None else serve_cells()
        self.descent_cells = descent_entry_cells() \
            if cfg.descent == "auto" else ()
        if not self.cells:
            raise ValueError("no serve cells configured (MWIS_SHAPES has "
                             "no kind='serve' rows)")
        self.cache = E.PlanCache(max_entries=cfg.cache_entries)
        # distinct (cell, backend, algo, schedule, e_blk) chunk shapes
        # solved: the reference's compiled programs (eager torch compiles
        # nothing per shape; the kernels are built once per process)
        self._programs: set = set()
        self._eblk_hwm: Dict[str, int] = {}
        # active backend: starts at cfg.backend, demoted down
        # FALLBACK_CHAIN when a chunk's solve fails
        self._backend = cfg.backend
        self._stage_totals = dict(pack=0.0, transfer=0.0, solve=0.0,
                                  fetch=0.0)       # cumulative ms per stage
        self._stage_log: deque = deque(maxlen=2048)  # per-chunk timing recs
        self._wall_s = 0.0                 # chunk-processing wall seconds
        self.counters = dict(
            requests=0, rejected=0, repaired=0, pack_errors=0,
            solve_errors=0, fallbacks=0, verify_checked=0,
            verify_failures=0, descent_solves=0, descents=0,
            oversize_admitted=0, chunks=0, pipelined_chunks=0,
            pipeline_retries=0,
        )
        self.events: List[tuple] = []   # (kind, detail) robustness log

    # ------------------------------------------------------------------ #
    # request admission
    # ------------------------------------------------------------------ #
    def _topology(self, g: Graph, cell: ServeCell, backend: str) -> Topology:
        key = (
            cell.name,
            E.topology_hash(g.edge_sources(), g.indices, g.n),
            backend != "torch",
        )
        return self.cache.get_or_build(
            key, lambda: _pack_topology(g, cell, backend, self.device)
        )

    def _batch_size(self, k: int) -> int:
        """Static batch size for a k-request chunk: the smallest admitted
        bucket, else k itself up to the largest bucket."""
        for b in CFG.MWIS_SERVE_BATCH_SIZES:
            if b >= k and b <= self.cfg.max_batch:
                return b
        return max(k, min(max(CFG.MWIS_SERVE_BATCH_SIZES),
                          self.cfg.max_batch))

    # ------------------------------------------------------------------ #
    # solving: pack -> stage (stack + H2D) -> solve -> fetch
    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        """Wait for the device, so each stage's time is its own."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log_stages(self, rec: dict) -> None:
        self.counters["chunks"] += 1
        for k in ("pack", "transfer", "solve", "fetch"):
            self._stage_totals[k] += rec[k + "_ms"]
        self._stage_log.append(dict(rec))

    def _pack_requests(
        self,
        cell: ServeCell,
        idxs: List[int],
        graphs: List[Graph],
        out: List[Optional[ServeResult]],
        backend: str,
    ) -> Tuple[List[Topology], List[int]]:
        """Per-request host packing with fault isolation; failed requests
        get error results in ``out`` and drop out of the chunk."""
        topos: List[Topology] = []
        good: List[int] = []
        for i in idxs:
            g = graphs[i]
            try:
                # per-request weight refill on a cached/fresh topology;
                # a raising pack stays OUT of the cache (get_or_build)
                topo = self._topology(g, cell, backend)
                topos.append(topo._replace(w0=_weight_plane(g, cell)))
                good.append(i)
            except Exception as e:  # noqa: BLE001 — isolate the request
                self.counters["pack_errors"] += 1
                self.events.append(("pack_error", cell.name, str(e)))
                out[i] = _error_result(g.n, V.REASON_PACK_FAILED, str(e))
        return topos, good

    def _stage_chunk(
        self, cell: ServeCell, topos: List[Topology], backend: str,
        rec: dict,
    ) -> _Staged:
        """Stack a chunk into one union problem of its static batch size
        (phantom repeat-last instances, sliced off on fetch) and copy its
        weight planes to the device."""
        t0 = time.perf_counter()
        k = len(topos)
        bt = self._batch_size(k)
        batch = list(topos) + [topos[-1]] * (bt - k)
        w0 = np.concatenate([t.w0 for t in batch])
        e_blk = 0
        if backend != "torch":
            need = max(t.prob.plan.edge_perm.shape[1] for t in batch)
            e_blk = max(self._eblk_hwm.get(cell.name, cell.e_blk), need)
            self._eblk_hwm[cell.name] = e_blk
        prob = D.stack_problems([t.prob for t in batch],
                                e_blk=e_blk or None)
        self._sync()
        t1 = time.perf_counter()
        prob = prob._replace(w0=torch.from_numpy(w0).to(self.device))
        self._sync()
        t2 = time.perf_counter()
        rec["pack_ms"] += (t1 - t0) * 1e3
        rec["transfer_ms"] += (t2 - t1) * 1e3
        rec["batch"] = bt
        return _Staged(cell=cell, backend=backend, topos=tuple(topos),
                       prob=prob, e_blk=e_blk, rec=rec)

    def _launch_chunk(self, staged: _Staged) -> _Inflight:
        """Solve the stacked chunk; its members stay on the device."""
        sched = self.cfg.schedule or staged.cell.schedule
        cfg, prob = self.cfg, staged.prob
        self._programs.add((staged.cell.name, staged.backend, cfg.algo,
                            sched, staged.e_blk))
        t0 = time.perf_counter()
        _, members = SOL.solve_union_arrays(
            prob.w0, prob.is_local, prob.is_ghost, prob.aux, prob.halo,
            prob.plan, algo=cfg.algo, heavy_k=cfg.heavy_k,
            use_heavy=cfg.use_heavy, sweeps=1_000_000,
            max_rounds=cfg.max_rounds, p=prob.p, schedule=sched,
            backend=staged.backend,
        )
        return _Inflight(staged=staged, members=members, t_dispatch=t0)

    def _fetch_chunk(self, inflight: _Inflight) -> List[np.ndarray]:
        """Wait for the solve and read back the [n_i] masks."""
        rec = inflight.staged.rec
        self._sync()
        t1 = time.perf_counter()
        rec["solve_ms"] += (t1 - inflight.t_dispatch) * 1e3
        members = inflight.members.cpu().numpy()
        rec["fetch_ms"] += (time.perf_counter() - t1) * 1e3
        self._log_stages(rec)
        return [members[i, : t.n]
                for i, t in enumerate(inflight.staged.topos)]

    def _execute_chunk(
        self, cell: ServeCell, topos: List[Topology], backend: str
    ) -> List[np.ndarray]:
        """Solve up to max_batch same-cell topologies; returns [n_i] masks.

        Raises on failure — `_solve_chunk` wraps it with the fallback
        chain.  (Tests monkeypatch this seam to inject backend failures.)
        """
        rec = dict(cell=cell.name, backend=backend, batch=0, devices=1,
                   pipelined=False, pack_ms=0.0, transfer_ms=0.0,
                   solve_ms=0.0, fetch_ms=0.0)
        staged = self._stage_chunk(cell, topos, backend, rec)
        return self._fetch_chunk(self._launch_chunk(staged))

    def _demote(self, backend: str, cell: ServeCell, err: Exception) -> bool:
        """After ``backend`` failed on ``cell``: demote the service to the
        next backend of its FALLBACK_CHAIN (True: retry there), or, with
        none left, count the failure (False).  A demotion sticks for the
        rest of the service's life."""
        chain = FALLBACK_CHAIN[self.cfg.backend]
        pos = chain.index(backend) if backend in chain else len(chain)
        if pos + 1 >= len(chain):
            self.counters["solve_errors"] += 1
            self.events.append(("backend_failed", cell.name, backend,
                                str(err)))
            return False
        self.counters["fallbacks"] += 1
        self.events.append(("fallback", backend, chain[pos + 1], str(err)))
        self._backend = chain[pos + 1]
        return True

    def _solve_chunk(
        self,
        cell: ServeCell,
        idxs: List[int],
        graphs: List[Graph],
        out: List[Optional[ServeResult]],
    ) -> None:
        """Pack + solve one (cell, ≤max_batch) chunk with per-request
        isolation and the backend fallback chain; fills ``out``."""
        while True:
            backend = self._backend
            topos, good = self._pack_requests(cell, idxs, graphs, out,
                                              backend)
            if not good:
                return
            try:
                masks = self._execute_chunk(cell, topos, backend)
            except Exception as e:  # noqa: BLE001 — degrade, don't abort
                if self._demote(backend, cell, e):
                    continue    # retry the chunk on the demoted backend
                for i in good:
                    out[i] = _backend_failed(graphs[i].n, backend, e)
                return
            for k, i in enumerate(good):
                out[i] = self._finish_result(
                    graphs[i], masks[k], check=(self.cfg.verify == "full")
                    or (self.cfg.verify == "sample" and k == 0))
            return

    def _run_chunks(
        self,
        chunks: List[Tuple[ServeCell, List[int]]],
        graphs: List[Graph],
        out: List[Optional[ServeResult]],
    ) -> None:
        """Run the batch's (cell, idxs) chunks one after another."""
        t_wall = time.perf_counter()
        for cell, idxs in chunks:
            self._solve_chunk(cell, idxs, graphs, out)
        self._wall_s += time.perf_counter() - t_wall

    def _solve_staged_one(self, g: Graph, cell: ServeCell) -> ServeResult:
        """One instance through the shape-descent path
        (:func:`repro_torch.core.solvers.solve_staged`): enter at
        ``cell``'s shape, shrink onto smaller cells as reduction collapses
        the kernel.  Descent plans go through the shared
        :class:`PlanCache` (counted in ``cache_descent_*``).  Same
        isolation contract as the batched path: never raises, walks the
        backend fallback chain (``cuda`` has none)."""
        cfg = self.cfg
        sched = cfg.schedule or cell.schedule
        while True:
            backend = self._backend
            dcfg = D.DisReduConfig(
                heavy_k=cfg.heavy_k, use_heavy=cfg.use_heavy, mode="sync",
                max_rounds=cfg.max_rounds, schedule=sched, backend=backend,
                r_blk=None if backend == "torch" else cell.r_blk,
                descent=True, descent_every=cfg.descent_every,
            )
            try:
                members, st = SOL.solve_staged(
                    g, 1, cfg.algo, dcfg, plan_cache=self.cache,
                    pad_to=dict(L=cell.L, G=cell.G, E=cell.E, B=cell.B,
                                S=cell.S),
                    window_cap=cell.D, common_cap=cell.Dc,
                    device=self.device,
                )
            except Exception as e:  # noqa: BLE001 — degrade, don't abort
                if self._demote(backend, cell, e):
                    continue
                return _backend_failed(g.n, backend, e)
            self.counters["descent_solves"] += 1
            self.counters["descents"] += int(st["descents"])
            return self._finish_result(
                g, members, check=self.cfg.verify in ("sample", "full"))

    def _finish_result(
        self, g: Graph, mask: np.ndarray, check: bool
    ) -> ServeResult:
        weight = int(g.weights[mask].sum(dtype=np.int64))
        if check:
            self.counters["verify_checked"] += 1
            rep = V.verify_result(g, mask, weight)
            if not rep.ok:
                self.counters["verify_failures"] += 1
                self.events.append(("verify_failure", rep.detail))
                return ServeResult(
                    members=mask, weight=weight, ok=False,
                    reason=rep.reason, error=f"{rep.reason}: {rep.detail}",
                )
        return ServeResult(members=mask, weight=weight)

    def solve_batch(self, graphs: Sequence[Graph]) -> List[ServeResult]:
        """Solve many instances; results in request order.

        Never raises for a bad request: malformed/oversize/unpackable
        instances come back as ``ok=False`` results with stable reason
        codes while the rest of the batch solves normally.
        """
        order: Dict[str, List[int]] = {}
        staged: List[Tuple[int, ServeCell]] = []
        cells_by_name = {c.name: c for c in self.cells}
        admitted: List[Graph] = list(graphs)
        out: List[Optional[ServeResult]] = [None] * len(graphs)
        for i, g in enumerate(graphs):
            self.counters["requests"] += 1
            if self.cfg.validate:
                fixed, rep = V.canonicalize(g)
                if not rep.ok:
                    self.counters["rejected"] += 1
                    self.events.append(("rejected", rep.reason, rep.detail))
                    try:
                        n_bad = int(g.n)
                    except Exception:  # noqa: BLE001 — malformed input
                        n_bad = 0
                    out[i] = _error_result(n_bad, rep.reason, rep.detail)
                    continue
                if rep.repairs:
                    self.counters["repaired"] += 1
                    self.events.append(("repaired", rep.repairs))
                admitted[i] = g = fixed
            if g.n == 0:    # trivially solved; skip the device entirely
                out[i] = ServeResult(members=np.zeros(0, bool), weight=0)
                continue
            try:
                cell = bucket_for(g.n, g.num_directed_edges, self.cells)
            except ValueError as e:
                # oversize for every serve cell — with descent on, admit
                # through a kind="descent" entry shape (staged path only)
                dcell = None
                if self.descent_cells:
                    try:
                        dcell = bucket_for(g.n, g.num_directed_edges,
                                           self.descent_cells)
                    except ValueError:
                        dcell = None
                if dcell is None:
                    self.counters["rejected"] += 1
                    self.events.append(
                        ("rejected", V.REASON_OVERSIZE, str(e)))
                    out[i] = _error_result(g.n, V.REASON_OVERSIZE, str(e))
                    continue
                self.counters["oversize_admitted"] += 1
                staged.append((i, dcell))
                continue
            if (self.cfg.descent == "auto"
                    and cell.L >= self.cfg.descent_min_L):
                staged.append((i, cell))
            else:
                order.setdefault(cell.name, []).append(i)

        chunks: List[Tuple[ServeCell, List[int]]] = []
        for cell_name, idxs in order.items():
            cell = cells_by_name[cell_name]
            for c0 in range(0, len(idxs), self.cfg.max_batch):
                chunks.append((cell, idxs[c0 : c0 + self.cfg.max_batch]))
        self._run_chunks(chunks, admitted, out)
        for i, cell in staged:
            out[i] = self._solve_staged_one(admitted[i], cell)
        return out  # type: ignore[return-value]

    def solve_one(self, g: Graph) -> ServeResult:
        return self.solve_batch([g])[0]

    @property
    def stats(self) -> dict:
        """The reference's stats keys: cache counters, chunk shapes, the
        active backend, and per-stage milliseconds (pack / transfer /
        solve / fetch; totals and per-chunk medians)."""
        s = self.cache.stats
        stage_ms = {k: round(v, 3) for k, v in self._stage_totals.items()}
        p50 = {}
        for k in ("pack", "transfer", "solve", "fetch"):
            vals = [r[k + "_ms"] for r in self._stage_log]
            p50[k] = round(float(np.median(vals)), 3) if vals else 0.0
        busy_ms = sum(self._stage_totals.values())
        wall_ms = self._wall_s * 1e3
        # fraction of summed stage time hidden under other chunks' time:
        # 0.0 when chunks run one after another, as here
        overlap = (max(0.0, 1.0 - wall_ms / busy_ms) if busy_ms > 0
                   else 0.0)
        return dict(
            cache_hits=s.hits, cache_misses=s.misses,
            cache_evictions=s.evictions, cache_size=s.size,
            cache_errors=s.errors,
            cache_descent_hits=s.descent_hits,
            cache_descent_misses=s.descent_misses,
            programs=len(self._programs), compiles=len(self._programs),
            e_blk_hwm=dict(self._eblk_hwm),
            backend=self.cfg.backend, backend_active=self._backend,
            devices=1,
            pipeline=self.cfg.pipeline,
            stage_ms=stage_ms,
            stage_p50_ms=p50,
            wall_ms=round(wall_ms, 3),
            overlap_ratio=round(overlap, 4),
            **self.counters,
        )


# --------------------------------------------------------------------- #
# sustained-throughput measurement (the serve CLI and chip_smoke.py)
# --------------------------------------------------------------------- #
def measure_throughput(
    service: MWISService,
    batches: Sequence[Sequence[Graph]],
    *,
    warmup: int = 1,
) -> dict:
    """Drive pre-built request batches through a service; returns
    instances/sec + per-batch latency percentiles (ms), host clock.
    Over a few batches p99 is interpolated next to the slowest one, so
    ``max_ms`` comes with it: read a tail only from a long stream.

    ``warmup`` counts full passes over the batch list before timing, so
    every topology is cached (and every kernel built) before the measured
    pass — the steady serving state.
    """
    for _ in range(warmup):
        for b in batches:
            service.solve_batch(list(b))
    lat = []
    n_inst = 0
    t0 = time.perf_counter()
    for b in batches:
        t1 = time.perf_counter()
        service.solve_batch(list(b))
        lat.append((time.perf_counter() - t1) * 1e3)
        n_inst += len(b)
    wall = time.perf_counter() - t0
    lat_a = np.asarray(lat)
    return dict(
        instances=n_inst,
        instances_per_sec=round(n_inst / wall, 1),
        p50_ms=round(float(np.percentile(lat_a, 50)), 3),
        p99_ms=round(float(np.percentile(lat_a, 99)), 3),
        max_ms=round(float(lat_a.max()), 3),
        batches=len(batches),
    )
