"""Process groups for the per-PE path: one rank of ``torch.distributed`` a PE.

Counterpart of :mod:`repro.launch.mesh`.  The reference lays PEs on a
``jax.sharding.Mesh`` axis ("pe") and runs one shard_map program over it;
here each PE is a process (a rank), spawned on one host with
``torch.multiprocessing`` (spawn, never fork: the parent may hold CUDA),
and the mesh axis is the ranks' process group.

  * :func:`pe_device` — rank r runs on ``cuda:(r % device_count)``, or on
    the CPU when the caller asks for it;
  * :func:`init_pe_group` — joins the group (``"nccl"`` or ``"gloo"``, the
    caller's choice; NCCL needs one card a rank and raises otherwise);
  * :func:`spawn_pes` — starts the ranks, runs one function on each and
    returns their outputs stacked [p, ...] as numpy, as the reference's
    shard_map ``run()`` does; any rank's failure raises in the caller;
  * :func:`run_shard_map` — runs the per-PE path: hands each rank its
    PE's arrays in files, spawns the ranks once and runs every
    :class:`PEJob` (``distributed.disredu_shard_map_fn`` or
    ``solvers.solver_shard_map_fn``) on them in :func:`shard_map_rank`;
  * :func:`make_serve_mesh` — the serving layer's batch axis
    (:mod:`repro_torch.core.serve`): the first N visible devices of one
    type, as :func:`visible_devices` lists them.  One process drives them
    all, a worker thread a device; no process group is involved.

Nothing switches backend or device when something fails.  The reference's
TPU pod meshes (``make_production_mesh``) have no counterpart.
"""

from __future__ import annotations

import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels, resolve_device
from repro_torch.core import distributed as D
from repro_torch.core import solvers as S

BACKENDS = ("nccl", "gloo")


def pe_device(rank: int, device: torch.device | str | None = None
              ) -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:(rank % device_count)``
    unless the caller asks for the CPU (``device="cpu"``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def visible_devices(kind: str) -> tuple[torch.device, ...]:
    """The devices of type ``kind`` a serve mesh may use: every visible
    CUDA card, or the one CPU.  The single place the serving layer learns
    what is visible; the CPU tests replace it to lay several shards on the
    CPU, as the reference's force host devices with ``XLA_FLAGS``."""
    if kind == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(kind),)


def make_serve_mesh(num_devices: int | None = None,
                    device: torch.device | str = "cuda"
                    ) -> tuple[torch.device, ...]:
    """The serve mesh: the first ``num_devices`` visible devices of
    ``device``'s type (``None``: every one).  Raises when more are asked
    for than are visible."""
    devs = visible_devices(torch.device(device).type)
    if num_devices is None:
        return devs
    if not 1 <= num_devices <= len(devs):
        raise ValueError(
            f"make_serve_mesh: requested {num_devices} device(s) but only "
            f"{len(devs)} visible")
    return devs[:num_devices]


def check_backend(backend: str, world: int,
                  device: torch.device | str | None = None) -> None:
    """Raise unless ``world`` ranks can run on ``backend``: NCCL needs a
    CUDA device and one card a rank (two ranks on one card are refused by
    NCCL itself); gloo runs any number of ranks on the CPU or on cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown process-group backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"NCCL needs one CUDA card a rank: {world} ranks asked, "
                f"{cards} card(s) visible; ask for fewer ranks or for the "
                f"gloo backend")
        if resolve_device(device).type != "cuda":
            raise ValueError("NCCL runs on CUDA devices only")


def init_pe_group(rank: int, world: int, *, backend: str, init_method: str,
                  device: torch.device | str | None = None) -> torch.device:
    """Join the PEs' process group as ``rank`` of ``world`` (the default
    group) and return this rank's device.  ``init_method`` is where the
    ranks meet: ``file://<path>`` (a file no rank has used) or
    ``tcp://localhost:<port>``."""
    check_backend(backend, world, device)
    dev = pe_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def _rank_main(fn, rank, world, backend, init_method, device, args, out_q):
    """A spawned rank: one CPU thread, join the group, run
    ``fn(rank, world, device, *args)``, put ``(rank, ok, result or
    traceback)`` on ``out_q``."""
    torch.set_num_threads(1)
    try:
        dev = init_pe_group(rank, world, backend=backend,
                            init_method=init_method, device=device)
        out_q.put((rank, True, fn(rank, world, dev, *args)))
    except Exception:  # reported to the parent, which raises
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def stack(outs: Sequence):
    """Per-rank outputs → one output with a leading [p] axis on every leaf
    (dicts and tuples are walked; leaves become numpy arrays)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack(list(z)) for z in zip(*outs))
    return np.stack([np.asarray(o) for o in outs])


def spawn_pes(fn: Callable, world: int, *, args: tuple = (),
              backend: str = "gloo", device: torch.device | str | None = None,
              init_method: str | None = None,
              timeout: float = 3600.0):
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks of
    one process group; return their results stacked [p, ...] (:func:`stack`).

    ``fn`` and ``args`` are pickled to every rank (``fn`` by import path:
    it must live in a module the ranks can import, never in a test module
    or ``__main__``), so hand large per-rank data over in files.  Each rank
    runs on :func:`pe_device` with one CPU thread.  ``init_method``
    defaults to a ``file://`` rendezvous in a fresh temporary directory.
    A rank that raises or dies, or a run past ``timeout`` seconds, stops
    every rank and raises here."""
    check_backend(backend, world, device)
    ctx = torch.multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pe_group_") as tmp:
        init = init_method or Path(tmp, "rendezvous").as_uri()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world, backend, init, device, args, out_q))
            for rank in range(world)]
        for proc in procs:
            proc.start()
        results: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    rank, ok, res = out_q.get(timeout=1.0)
                except queue.Empty:
                    # a rank puts its result before it exits 0
                    dead = [r for r, proc in enumerate(procs)
                            if r not in results
                            and proc.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} exited without a result "
                            f"(exit codes "
                            f"{[procs[r].exitcode for r in dead]})") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"the ranks ran past {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{res}")
                results[rank] = res
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    return stack([results[r] for r in range(world)])


# --------------------------------------------------------------------- #
# the per-PE path's jobs: hand-off files, one spawn, every job in order
# --------------------------------------------------------------------- #
class PEJob(NamedTuple):
    """One run of the per-PE path in :func:`run_shard_map`: ``algo``
    (reduce | greedy | rg | rnp) under ``cfg`` on partition ``part``."""

    algo: str
    cfg: D.DisReduConfig
    part: int = 0


def shard_map_rank(rank: int, world: int, device: torch.device,
                   directory: str, jobs, t_spawn: float) -> dict:
    """Rank entry of :func:`run_shard_map` (started by :func:`spawn_pes`):
    run each ``(file set,
    job)`` of ``jobs`` in order on this rank's PE, its arrays loaded from
    ``<directory>/<file set>_pe<rank>.npz``.  Per job: the outputs as numpy
    (``w``, ``status``, ``offset``, ``log_n``, ``rounds``, and the fold log
    for reduce or ``members`` for the solvers), the run's wall ``seconds``
    (host→device copy included, file load not), ``load_seconds``, and this
    rank's kernel ``launches`` in the run, by kernel.  ``ready`` is the
    seconds from the spawn to this rank joining the group."""
    ready = time.time() - t_spawn
    out = []
    for name, job in jobs:
        t0 = time.time()
        with np.load(f"{directory}/{name}_pe{rank}.npz") as f:
            a = dict(f)
        load_s = time.time() - t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        kernels.reset_launch_counts()
        t0 = time.time()
        if job.algo == "reduce":
            state, rounds = D.disredu_shard_map_fn(a, job.cfg, device=device)
            res = dict(log_kind=state.log_kind, log_v=state.log_v,
                       log_u=state.log_u)
        else:
            state, members, rounds = S.solver_shard_map_fn(
                a, job.cfg, job.algo, device=device)
            res = dict(members=members)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.time() - t0
        res.update(w=state.w, status=state.status, offset=state.offset,
                   log_n=state.log_n)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        res.update(rounds=rounds, seconds=seconds, load_seconds=load_s,
                   launches={k: kernels.launch_count(k)
                             for k in kernels.KERNELS})
        out.append(res)
    return dict(jobs=out, ready=ready)


def run_shard_map(parts, jobs, *, backend: str = "gloo",
                  device: torch.device | str | None = None,
                  directory: str | None = None):
    """Run ``jobs`` (:class:`PEJob`) on the per-PE path: one spawned rank a
    PE, started once for all of them.

    ``parts`` are the partitions the jobs name (one PE count).  Each rank
    gets its PE's arrays through files (one ``.npz`` a PE and partition,
    written with the ranks' rendezvous file in a temporary directory
    under ``directory``, default the system's; a partition's plan is
    packed once for the jobs that share its backend class and r_blk), then :func:`shard_map_rank` runs every job in order.  Returns
    ``(outs, stats)``: per job the ranks' outputs stacked [p, ...]
    (``launches`` per kernel), and ``handoff_seconds`` (packing and
    writing the files), ``spawn_seconds`` (until the last rank joined the
    group), ``seconds`` (the whole call)."""
    p = parts[0].p
    if any(pg.p != p for pg in parts):
        raise ValueError("run_shard_map needs partitions of one PE count")
    check_backend(backend, p, device)
    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="pe_arrays_",
                                     dir=directory) as tmp:
        names, written = [], {}
        for job in jobs:
            key = (job.part, job.cfg.backend == "torch", job.cfg.r_blk)
            if key not in written:
                written[key] = f"part{job.part}_{len(written)}"
                arrs = D.shard_map_arrays(parts[job.part], job.cfg)
                for i in range(p):
                    np.savez(f"{tmp}/{written[key]}_pe{i}.npz",
                             **{k: v[i] for k, v in arrs.items()})
            names.append(written[key])
        t_spawn = time.time()
        res = spawn_pes(shard_map_rank, p, backend=backend, device=device,
                        init_method=Path(tmp, "rendezvous").as_uri(),
                        args=(tmp, list(zip(names, jobs)), t_spawn))
    stats = dict(handoff_seconds=t_spawn - t_start,
                 spawn_seconds=float(res["ready"].max()),
                 seconds=time.time() - t_start)
    return res["jobs"], stats
