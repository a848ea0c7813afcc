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
  * **the serve mesh** — the reference shards a stacked chunk's batch
    axis over a ``serve`` mesh and runs one SPMD program.  Here the mesh
    is the first ``devices`` visible devices of ``ServeConfig.device``'s
    type (:func:`repro_torch.launch.mesh.make_serve_mesh`) and the padded
    chunk splits into one stacked union problem a device (a *shard*),
    each solved by its own worker thread on its own CUDA stream.  Batch
    sizes round up to a multiple of the active device count with phantom
    repeat-last instances, as the reference's do.  Each shard runs to its
    own fixpoint (the reference couples trip counts through its
    while-loop's OR); every round body is idempotent at its fixpoint, so
    each instance's bits are the same either way.
  * **the chunk pipeline** — the reference's control flow
    (``_dispatch_chunk`` / ``_retire_chunk`` / ``_run_chunks``): while
    chunk k solves, the calling thread packs and stacks chunk k+1 on each
    device's copy stream and copies its weight planes from pinned host
    memory without blocking; the shard's solve stream waits on the copy's
    event.  "Launch without blocking" means handing the shard to its
    device's worker thread (the port's solve is a host loop); the worker
    returns the members and touches no service state.  A dispatch or
    in-flight failure, a worker's exception included, re-runs the chunk
    through the synchronous path, which owns the fallback chain.
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
  * **device** — cached problems, and the descent path, live on the
    serve mesh's first device (``ServeConfig.device`` names the type,
    default ``cuda``; without a visible GPU the service refuses to start
    unless ``device="cpu"``); a shard's weight planes go host→device in
    one copy.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor, wait
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
from repro_torch.launch import mesh as M

#: Backend degradation order: a failing backend falls to the next entry.
#: ``cuda`` (the hand-written kernel) has none: its failure is an error.
FALLBACK_CHAIN = {
    "cuda": ("cuda",),
    "blocked": ("blocked", "torch"),
    "torch": ("torch",),
}


class ServeCell(NamedTuple):
    """One resolved serving bucket (a kind="serve" MWIS_SHAPES row)."""

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
    serve_devices: Optional[int] = None  # batch-axis device cap (None=mesh)
    pipeline: bool = True                # overlapped chunk pipeline opt-out


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
            **CFG.serve_knobs(name),
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


def _to_device(x, dev: torch.device):
    """A union problem (NamedTuples of tensors) copied to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, dev) for v in x))
    return x


class _Lane(NamedTuple):
    """One serve-mesh device as the service drives it: a worker thread
    that solves its shards one after another, and, on a CUDA device, a
    copy stream (stacking and weight planes) and a solve stream (None on
    the CPU)."""

    device: torch.device
    worker: ThreadPoolExecutor
    copy: Optional[torch.cuda.Stream]
    solve: Optional[torch.cuda.Stream]


class _Staged(NamedTuple):
    """A chunk stacked into one union problem a shard, each on its lane's
    device with its copies issued, ready to solve."""

    cell: ServeCell
    backend: str
    topos: Tuple[Topology, ...]   # the real (unpadded) chunk members
    probs: Tuple[D.UnionProblem, ...]  # a shard each, p = batch / shards
    ready: tuple                  # a shard's copy-done CUDA event, or None
    e_blk: int
    rec: dict                     # per-chunk stage-timing record


class _Inflight(NamedTuple):
    """A launched chunk: one worker future a shard, each giving the
    shard's members [p, L+G+1] bool on its device once its stream is
    done."""

    staged: _Staged
    futures: Tuple[Future, ...]
    t_dispatch: float


class _Pending(NamedTuple):
    """A dispatched pipeline chunk awaiting retirement.  ``inflight`` is
    None when dispatch itself failed — the retire step then re-runs the
    chunk through the synchronous fallback-chain path."""

    inflight: Optional[_Inflight]
    cell: ServeCell
    good: List[int]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (algo/backend/schedule as in DisReduConfig)."""

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
    # --- multi-device batch sharding + overlapped chunk pipeline ------ #
    devices: Optional[int] = None  # serve-mesh size (None = every visible
                                   # device; > visible raises at init)
    pipeline: bool = True          # pack/stage/copy chunk k+1 while chunk
                                   # k solves
    # --- shape descent (solvers.solve_staged) ------------------------- #
    descent: str = "off"          # off | auto — big cells take the staged
                                  # path and shrink mid-solve
    descent_min_L: int = 1024     # smallest cell L routed through descent
                                  # (default: serve_m and up)
    descent_every: int = 2        # stage length between descent checks
    device: str = "cuda"          # device type the service solves on
                                  # (cuda | cpu; the mesh picks the cards)


class MWISService:
    """Bucketing → plan cache → stacked union solve a shard.

    ``solve_batch`` groups requests by serve cell, pads each group to a
    static batch size (:data:`repro_torch.configs.mwis.
    MWIS_SERVE_BATCH_SIZES`, rounded up to a multiple of the active device
    count; phantom repeat-last instances, as the reference does) and
    solves each (cell, ≤ max_batch) chunk as one stacked problem a serve
    device, chunk k+1 staged while chunk k solves.  Results come back in
    request order.  :meth:`close` stops the worker threads.
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
        dev = resolve_device(cfg.device)
        if dev.index is not None:
            raise ValueError(
                f"ServeConfig.device={cfg.device!r}: give the device type "
                "(cuda | cpu); the serve mesh takes the first `devices` "
                "visible devices of it")
        visible = len(M.visible_devices(dev.type))
        if cfg.devices is not None and not 1 <= cfg.devices <= visible:
            raise ValueError(
                f"serve devices={cfg.devices} exceeds the {visible} "
                f"visible {dev.type} device(s)")
        self.cfg = cfg
        self._ndev = cfg.devices if cfg.devices is not None else visible
        self._lanes = tuple(
            _Lane(device=d,
                  worker=ThreadPoolExecutor(1, thread_name_prefix="serve"),
                  copy=torch.cuda.Stream(d) if d.type == "cuda" else None,
                  solve=torch.cuda.Stream(d) if d.type == "cuda" else None)
            for d in M.make_serve_mesh(self._ndev, dev.type))
        # cached problems and the descent path: the mesh's first device
        self.device = self._lanes[0].device
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

    def close(self) -> None:
        """Stop the worker threads (after the shards queued on them)."""
        for lane in self._lanes:
            lane.worker.shutdown()

    def _cell_ndev(self, cell: Optional[ServeCell]) -> int:
        """Active device count for a cell's batch axis (cell cap ∧ mesh)."""
        nd = max(1, self._ndev)
        if cell is not None and cell.serve_devices:
            nd = min(nd, cell.serve_devices)
        return nd

    def _batch_size(self, k: int, cell: Optional[ServeCell] = None) -> int:
        """Static batch size for a k-request chunk: the smallest admitted
        bucket, rounded up to a multiple of the active device count so the
        batch splits into equal shards."""
        nd = self._cell_ndev(cell)

        def up(b: int) -> int:
            return ((b + nd - 1) // nd) * nd

        for b in CFG.MWIS_SERVE_BATCH_SIZES:
            if b >= k and b <= self.cfg.max_batch:
                return up(b)
        return up(max(k, min(max(CFG.MWIS_SERVE_BATCH_SIZES),
                             self.cfg.max_batch)))

    # ------------------------------------------------------------------ #
    # solving: pack -> stage (stack + H2D a shard) -> solve -> fetch
    # ------------------------------------------------------------------ #
    def _new_rec(self, cell: ServeCell, backend: str,
                 pipelined: bool) -> dict:
        return dict(cell=cell.name, backend=backend, batch=0, devices=1,
                    pipelined=pipelined, pack_ms=0.0, transfer_ms=0.0,
                    solve_ms=0.0, fetch_ms=0.0)

    def _log_stages(self, rec: dict) -> None:
        self.counters["chunks"] += 1
        if rec["pipelined"]:
            self.counters["pipelined_chunks"] += 1
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
        """Stack a chunk to its static batch size (phantom repeat-last
        instances, sliced off on fetch), split it into one union problem
        a shard over the cell's serve devices, and copy each shard's
        weight planes from pinned host memory without blocking, all on
        the lanes' copy streams.  A pipelined chunk does not wait: its
        shards' solve streams wait on the ``ready`` events.  A synchronous
        chunk waits for the copy streams, so its pack and transfer times
        are the device's, as before the pipeline."""
        t0 = time.perf_counter()
        k = len(topos)
        nd = self._cell_ndev(cell)
        bt = self._batch_size(k, cell)
        batch = list(topos) + [topos[-1]] * (bt - k)
        shards = [batch[s * bt // nd:(s + 1) * bt // nd] for s in range(nd)]
        lanes = self._lanes[:nd]
        e_blk = 0
        if backend != "torch":
            need = max(t.prob.plan.edge_perm.shape[1] for t in batch)
            e_blk = max(self._eblk_hwm.get(cell.name, cell.e_blk), need)
            self._eblk_hwm[cell.name] = e_blk
        sync = not rec["pipelined"]
        probs = []
        for lane, part in zip(lanes, shards):
            with torch.cuda.stream(lane.copy):
                if lane.copy is not None:
                    # the cached problems were built on the calling
                    # thread's stream of the service's device
                    lane.copy.wait_stream(torch.cuda.current_stream(
                        self.device))
                prob = D.stack_problems([t.prob for t in part],
                                        e_blk=e_blk or None)
                if lane.device != self.device:
                    prob = _to_device(prob, lane.device)
            probs.append(prob)
            if sync and lane.copy is not None:
                lane.copy.synchronize()
        t1 = time.perf_counter()
        ready = []
        for s, (lane, part) in enumerate(zip(lanes, shards)):
            n = sum(t.w0.shape[0] for t in part)
            if lane.copy is None:
                w0 = torch.empty(n, dtype=torch.int32)
            else:
                # a pinned block is reused only after the copies issued
                # from it are done (torch's caching host allocator)
                w0 = torch.empty(n, dtype=torch.int32, pin_memory=True)
            np.concatenate([t.w0 for t in part], out=w0.numpy())
            event = None
            with torch.cuda.stream(lane.copy):
                if lane.copy is not None:
                    w0 = w0.to(lane.device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(lane.copy)
            probs[s] = probs[s]._replace(w0=w0)
            ready.append(event)
            if sync and event is not None:
                event.synchronize()
        t2 = time.perf_counter()
        rec["pack_ms"] += (t1 - t0) * 1e3
        rec["transfer_ms"] += (t2 - t1) * 1e3
        rec["batch"] = bt
        rec["devices"] = nd
        return _Staged(cell=cell, backend=backend, topos=tuple(topos),
                       probs=tuple(probs), ready=tuple(ready), e_blk=e_blk,
                       rec=rec)

    def _solve_shard(self, staged: _Staged, s: int) -> torch.Tensor:
        """Worker body: solve shard ``s`` of ``staged`` on its lane's solve
        stream, after its copies; returns its members once the stream is
        done, so nothing of the shard is in flight after it returns (the
        staged tensors outlive the call; no ``record_stream`` is needed).
        Reads the config and touches no other service state."""
        lane, prob = self._lanes[s], staged.probs[s]
        cfg = self.cfg
        with torch.cuda.stream(lane.solve):
            try:
                if lane.solve is not None:
                    lane.solve.wait_event(staged.ready[s])
                _, members = SOL.solve_union_arrays(
                    prob.w0, prob.is_local, prob.is_ghost, prob.aux,
                    prob.halo, prob.plan, algo=cfg.algo,
                    heavy_k=cfg.heavy_k, use_heavy=cfg.use_heavy,
                    sweeps=1_000_000, max_rounds=cfg.max_rounds, p=prob.p,
                    schedule=cfg.schedule or staged.cell.schedule,
                    backend=staged.backend,
                )
            finally:
                if lane.solve is not None:
                    lane.solve.synchronize()
        return members

    def _launch_chunk(self, staged: _Staged) -> _Inflight:
        """Hand each shard to its lane's worker; returns without blocking
        (the calling thread is free to stage the next chunk)."""
        sched = self.cfg.schedule or staged.cell.schedule
        self._programs.add((staged.cell.name, staged.backend, self.cfg.algo,
                            sched, staged.e_blk))
        t0 = time.perf_counter()
        futures = tuple(
            self._lanes[s].worker.submit(self._solve_shard, staged, s)
            for s in range(len(staged.probs)))
        return _Inflight(staged=staged, futures=futures, t_dispatch=t0)

    def _fetch_chunk(self, inflight: _Inflight) -> List[np.ndarray]:
        """Wait for every shard and read back the [n_i] masks; a shard's
        exception (a worker's) is raised here."""
        rec = inflight.staged.rec
        wait(inflight.futures)
        t1 = time.perf_counter()
        rec["solve_ms"] += (t1 - inflight.t_dispatch) * 1e3
        members = np.concatenate([f.result().cpu().numpy()
                                  for f in inflight.futures])
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
        rec = self._new_rec(cell, backend, pipelined=False)
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
            self._finish_chunk(good, graphs, masks, out)
            return

    def _finish_chunk(self, good: List[int], graphs: List[Graph],
                      masks: List[np.ndarray],
                      out: List[Optional[ServeResult]]) -> None:
        for k, i in enumerate(good):
            out[i] = self._finish_result(
                graphs[i], masks[k], check=(self.cfg.verify == "full")
                or (self.cfg.verify == "sample" and k == 0))

    # ------------------------------------------------------------------ #
    # the double-buffered chunk pipeline
    # ------------------------------------------------------------------ #
    def _dispatch_chunk(
        self,
        cell: ServeCell,
        idxs: List[int],
        graphs: List[Graph],
        out: List[Optional[ServeResult]],
    ) -> Optional[_Pending]:
        """Pack + stage + launch one chunk without blocking.  Returns None
        when nothing in the chunk is solvable; a dispatch failure comes
        back as a `_Pending` with ``inflight=None`` — retired by re-running
        the chunk through the synchronous fallback-chain path."""
        backend = self._backend
        rec = self._new_rec(cell, backend, pipelined=True)
        t0 = time.perf_counter()
        topos, good = self._pack_requests(cell, idxs, graphs, out, backend)
        rec["pack_ms"] += (time.perf_counter() - t0) * 1e3
        if not good:
            return None
        try:
            staged = self._stage_chunk(cell, topos, backend, rec)
            inflight = self._launch_chunk(staged)
        except Exception as e:  # noqa: BLE001 — degrade via the sync path
            self.counters["pipeline_retries"] += 1
            self.events.append(
                ("pipeline_retry", cell.name, backend, str(e)))
            return _Pending(inflight=None, cell=cell, good=good)
        return _Pending(inflight=inflight, cell=cell, good=good)

    def _retire_chunk(
        self,
        pending: _Pending,
        graphs: List[Graph],
        out: List[Optional[ServeResult]],
    ) -> None:
        """Fetch a dispatched chunk and finish its results; any failure
        (dispatch or in-flight, a worker's exception included) re-runs
        the chunk synchronously through `_solve_chunk`, which owns the
        backend fallback chain."""
        if pending.inflight is None:
            self._solve_chunk(pending.cell, pending.good, graphs, out)
            return
        try:
            masks = self._fetch_chunk(pending.inflight)
        except Exception as e:  # noqa: BLE001 — degrade via the sync path
            self.counters["pipeline_retries"] += 1
            self.events.append(
                ("pipeline_retry", pending.cell.name,
                 pending.inflight.staged.backend, str(e)))
            self._solve_chunk(pending.cell, pending.good, graphs, out)
            return
        self._finish_chunk(pending.good, graphs, masks, out)

    def _run_chunks(
        self,
        chunks: List[Tuple[ServeCell, List[int]]],
        graphs: List[Graph],
        out: List[Optional[ServeResult]],
    ) -> None:
        """Run the batch's (cell, idxs) chunks, double-buffered: chunk
        k+1 is packed/staged/launched while chunk k's solve is in flight.
        Cells opted out of pipelining (and single-chunk batches) take the
        synchronous path — results are identical either way, only the
        overlap differs."""
        t_wall = time.perf_counter()
        pipe = self.cfg.pipeline and len(chunks) > 1
        pending: Optional[_Pending] = None
        for cell, idxs in chunks:
            if not (pipe and cell.pipeline):
                if pending is not None:
                    self._retire_chunk(pending, graphs, out)
                    pending = None
                self._solve_chunk(cell, idxs, graphs, out)
                continue
            nxt = self._dispatch_chunk(cell, idxs, graphs, out)
            if pending is not None:
                self._retire_chunk(pending, graphs, out)
            pending = nxt
        if pending is not None:
            self._retire_chunk(pending, graphs, out)
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
        # 0.0 when serial (wall >= busy), higher when pipelined
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
            devices=max(1, self._ndev),
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
