"""MWIS solver CLI — the paper's workload end to end, on the port.

    PYTHONPATH=src python -m repro_torch.launch.mwis_run \
        --family rgg --n 20000 --p 8 --algo rnp --mode async --backend cuda

Generates an instance, partitions it with halos, runs the chosen distributed
solver on the union simulation path (all PEs on one device), verifies
independence and reports quality vs the sequential baseline.  Same flags and
stats lines as ``repro.launch.mwis_run``, plus ``--device`` (default cuda;
without a visible GPU it raises unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.core import distributed as D
from repro_torch.core import partition as part
from repro_torch.core import solvers as S
from repro_torch.graphs import generators as gen
from repro_torch.graphs.relabel import relabel_bfs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="rhg",
                    choices=("rhg", "rgg", "gnm"))
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--algo", default="rnp",
                    choices=("reduce", "greedy", "rg", "rnp"))
    ap.add_argument("--mode", default="async", choices=("sync", "async"))
    ap.add_argument("--exchange", default="allgather",
                    choices=("allgather", "a2a"),
                    help="collective of the multi-device path; accepted "
                         "for the reference's flag set and unused here (the "
                         "union path indexes boards directly)")
    ap.add_argument("--window-cap", type=int, default=16)
    ap.add_argument("--heavy-k", type=int, default=8)
    ap.add_argument("--schedule", default="cheap",
                    help="named rule schedule "
                         "(repro_torch.core.engine.SCHEDULES)")
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "blocked", "cuda"),
                    help="aggregate backend for the rule-test reductions")
    ap.add_argument("--device", default="cuda",
                    help="torch device the solve runs on (cuda | cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-seq", action="store_true")
    ap.add_argument("--bfs-relabel", action="store_true",
                    help="locality relabel (partitioning variant, Table C.3)")
    return ap


def prepare(args: argparse.Namespace):
    """Generate and partition the instance; returns (graph, partition)."""
    g = gen.FAMILIES[args.family](args.n, seed=args.seed)
    if args.bfs_relabel:
        g = relabel_bfs(g)
    print(f"instance: {args.family} n={g.n} m={g.m}")
    t0 = time.time()
    pg = part.partition_graph(g, args.p, window_cap=args.window_cap)
    print(f"partition: p={args.p} L={pg.L} G={pg.G} E={pg.E} "
          f"B={pg.B} ({time.time() - t0:.2f}s)")
    return g, pg


def run(args: argparse.Namespace, g, pg) -> dict:
    """Solve the partitioned instance and print the stats line(s).

    Returns the union ``prob``, the final ``state``, the global ``members``
    mask, ``rounds`` (DisRedu rounds for --algo reduce, peel iterations for
    rnp, else 0), ``seconds`` (the printed time, which includes the union
    build), ``build_seconds`` and, for the solver algos, ``weight``."""
    cfg = D.DisReduConfig(
        heavy_k=args.heavy_k, mode=args.mode, schedule=args.schedule,
        backend=args.backend,
    )
    t0 = time.time()
    prob = D.build_union_problem(pg, cfg.backend, cfg.r_blk, args.device)
    build_s = time.time() - t0
    if args.algo == "reduce":
        state, rounds = D.disredu_union(prob, cfg)
        nv, ne = D.kernel_stats(pg, state)
        dt = time.time() - t0
        print(f"DisRedu{'A' if args.mode == 'async' else 'S'}: "
              f"rounds={rounds} time={dt:.2f}s "
              f"|V'|/|V|={nv / g.n:.4f} |E'|/|E|={ne / max(g.m, 1):.4f} "
              f"offset={int(state.offset)}")
        members = D.members_global(pg, state, prob.aux)
        return dict(prob=prob, state=state, members=members, rounds=rounds,
                    seconds=dt, build_seconds=build_s)

    state, in_set, trips = S.solve_union(prob, args.algo, cfg)
    members = S.global_members(pg, prob, in_set)
    dt = time.time() - t0
    if not g.is_independent_set(members):
        raise RuntimeError("solution must be independent!")
    w = g.set_weight(members)
    print(f"{args.algo}/{args.mode}: weight={w} |I|={members.sum()} "
          f"time={dt:.2f}s")

    if args.compare_seq:
        from repro_torch.core import sequential as seq

        t0 = time.time()
        w_seq, _ = seq.solve_reduce_and_peel(g)
        print(f"sequential RnP baseline: weight={w_seq} "
              f"time={time.time() - t0:.2f}s quality={w / max(w_seq, 1):.4f}")
    return dict(prob=prob, state=state, members=members, rounds=trips,
                seconds=dt, build_seconds=build_s, weight=w)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # fail before the host-side preparation
    g, pg = prepare(args)
    run(args, g, pg)


if __name__ == "__main__":
    main()
