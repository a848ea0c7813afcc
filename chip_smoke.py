#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                    # the full-size run
    python3 chip_smoke.py --n 65536          # a smaller, quicker instance

Phases, in order (any failure exits non-zero; no phase catches and
continues):

  1. device  — the card as ``nvidia-smi`` names it, with its power limit;
  2. build   — compile the CUDA kernel from the sources in this checkout;
  3. kernel  — the fused segment-reduction kernel against its plain torch
               version at the test shapes (exact: all payloads are int32);
  4. main path — ``repro_torch.launch.mwis_run`` on RGG n = 2^20, p = 4
               (L ≈ 2^18, E ≈ 2^21 per PE), DisReduA, partitioned once:
               reduce/cheap-fused on the ``cuda`` backend, the same on the
               ``torch`` backend (must agree bit for bit), rg/edges-only on
               ``cuda``.  Kernel launch counts are reset before and read
               after each run, and must be > 0 on the ``cuda`` runs;
  5. kernel at full size — the kernel against its plain version on the
               full-size plan with the run's real payload columns, timed
               with CUDA events beside its bound and a scatter_reduce
               yardstick;
  6. replay  — the host time of the fold-log replay
               (``rules.reconstruct_members``) of the full-size runs;
  7. rnp     — rnp/edges-only on ``cuda`` at ``--rnp-n`` (its host-driven
               peel loop does not fit the time limit at full size);
  8. oracle  — greedy on the card equals the sequential priority greedy;
  9. profile — the full-size reduce run again under torch.profiler: device
               time by kernel and the device's busy share of the wall time.

Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
#: The data sheet's float32 rate outside the tensor cores; int32 ALU work
#: runs at no more than this, so it gives a lower bound on the op time.
CUDA_CORE_OPS_PER_S = 67e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            fail("kernel and plain version disagree on the payload groups")
        if g is not None:
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def kernel_at_test_shapes(dev) -> int:
    """Phase 3: random payloads at the unit-test shapes, OR inputs with
    bits above or_nbits; returns the max abs error (must be 0)."""
    import numpy as np
    import torch

    from repro_torch.kernels.segment_coo.ops import (
        pack_blocks, segment_fused_coo, segment_fused_plain,
    )

    rng = np.random.default_rng(0)
    err = 0
    names = ("data_sum", "data_max", "data_min", "data_or")
    for n_rows, n_edges, r_blk, widths, nbits in [
        (17, 120, 8, (2, 2, 1, 0), 16), (64, 9, 8, (2, 2, 1, 0), 16),
        (33, 257, 16, (0, 0, 0, 2), 16), (17, 120, 8, (1, 0, 0, 2), 12),
        (64, 9, 8, (0, 0, 0, 2), 5), (40, 300, 64, (2, 2, 0, 2), 8),
        (100_000, 800_000, 64, (2, 2, 1, 2), 16),
    ]:
        row = np.sort(rng.integers(0, n_rows, n_edges)).astype(np.int32)
        perm, lrow, _ = pack_blocks(row, n_rows, r_blk=r_blk,
                                    e_blk_multiple=8)
        perm = torch.from_numpy(perm.astype(np.int32)).to(dev)
        lrow = torch.from_numpy(lrow).to(dev)
        data = {k: torch.from_numpy(
                    rng.integers(-(1 << 20), 1 << 20, (n_edges, d))
                    .astype(np.int32)).to(dev)
                for k, d in zip(names, widths) if d}
        kw = dict(r_blk=r_blk, or_nbits=nbits, **data)
        got = segment_fused_coo(perm, lrow, n_rows, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, segment_fused_plain(perm, lrow, n_rows, **kw))
        phase("kernel", f"n_rows={n_rows} E={n_edges} r_blk={r_blk} "
                        f"widths={widths} or_nbits={nbits}: max_abs_err={e}")
        err = max(err, e)
    return err


def drive(args, g, pg, label: str, need_launches: bool, **over) -> dict:
    """One main-path run through ``mwis_run.run``, launch counts reset just
    before and read just after."""
    import torch

    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.launch import mwis_run

    a = argparse.Namespace(**{**vars(args), **over})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_count()
    res = mwis_run.run(a, g, pg)
    torch.cuda.synchronize()
    res["launches"] = K.launch_count()
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    phase("main", f"{label}: {a.algo}/{a.schedule}/{a.backend} "
                  f"rounds={res['rounds']} seconds={res['seconds']:.3f} "
                  f"(union build {res['build_seconds']:.3f}) "
                  f"offset={int(res['state'].offset)} "
                  f"weight={res.get('weight')} "
                  f"members={int(res['members'].sum())} "
                  f"kernel_launches={res['launches']} "
                  f"peak_device_gb={res['peak_gb']:.2f}")
    if need_launches and res["launches"] <= 0:
        fail(f"{label}: the cuda backend never launched the kernel")
    if not need_launches and res["launches"] != 0:
        fail(f"{label}: the kernel launched on a non-cuda backend")
    if not g.is_independent_set(res["members"]):
        fail(f"{label}: the member set is not independent")
    return res


def same_result(a: dict, b: dict) -> bool:
    import numpy as np
    import torch

    sa, sb = a["state"], b["state"]
    return (all(torch.equal(getattr(sa, f).cpu(), getattr(sb, f).cpu())
                for f in ("status", "w", "offset", "log_n"))
            and a["rounds"] == b["rounds"]
            and np.array_equal(a["members"], b["members"]))


def kernel_at_full_size(res: dict, reps: int) -> dict:
    """Phase 5: the kernel on the full-size plan with the real payload
    columns of the reduce run's final state (S/deg sums, M/only maxes,
    wbits/wnh ORs), against its plain version; times and bound."""
    import numpy as np
    import torch

    from repro_torch.core import engine as E
    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.kernels.segment_coo.ops import segment_fused_plain

    prob, state = res["prob"], res["state"]
    plan, aux = prob.plan, prob.aux
    req = E.schedule_requires(E.SCHEDULES["cheap-fused"])
    _, _, dsum, dmax, dor = E.ctx_payloads(state, aux, req,
                                           window_bits=True, plan=plan)
    n_rows = state.w.shape[0]
    nbits = aux.window.shape[1]
    kw = dict(r_blk=plan.r_blk, data_sum=dsum, data_max=dmax, data_or=dor,
              or_nbits=nbits)
    got = K.segment_fused(plan.edge_perm, plan.lrow, n_rows, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, segment_fused_plain(plan.edge_perm, plan.lrow,
                                               n_rows, **kw))
    if err:
        fail(f"kernel != plain version on the full-size plan ({err})")

    n_blocks, e_blk = plan.edge_perm.shape
    n_edges = dsum.shape[0]
    live = int((plan.lrow < plan.r_blk).sum())
    cols = dsum.shape[1] + dmax.shape[1] + dor.shape[1]
    ms = cuda_ms(lambda: K.segment_fused(plan.edge_perm, plan.lrow, n_rows,
                                         **kw), reps)
    plain_ms = cuda_ms(lambda: segment_fused_plain(
        plan.edge_perm, plan.lrow, n_rows, **kw), max(reps // 10, 2),
        warmup=1)
    # yardstick only (the port never calls it): scatter_reduce over the
    # row-sorted COO for the same sum and max columns (torch has no OR
    # reduce, so the OR columns are left out of it)
    row = aux.row.long()
    isum = row[:, None].expand_as(dsum)
    imax = row[:, None].expand_as(dmax)

    def library():
        s = torch.zeros((n_rows, dsum.shape[1]), dtype=torch.int32,
                        device=row.device)
        m = torch.full((n_rows, dmax.shape[1]), torch.iinfo(torch.int32).min,
                       dtype=torch.int32, device=row.device)
        return (s.scatter_reduce_(0, isum, dsum, "sum"),
                m.scatter_reduce_(0, imax, dmax, "amax"))

    lib = library()
    torch.cuda.synchronize()
    if not (torch.equal(lib[0], got[0]) and torch.equal(lib[1], got[1])):
        fail("scatter_reduce yardstick disagrees with the kernel")
    library_ms = cuda_ms(library, reps)
    # least bytes: lrow once, edge_perm for the live slots only, each live
    # edge's payload row once, the [n_rows, cols] outputs once
    n_bytes = 4 * (n_blocks * e_blk + live + n_edges * cols + n_rows * cols)
    n_ops = live * cols
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               max_abs_err=err)
    real = int((aux.gid[aux.row.long()] >= 0).sum())
    row_np = aux.row.cpu().numpy()
    for r in E.R_BLK_CANDIDATES:  # the packing census autotune chose from
        nb = -(-n_rows // r)
        eb = -(-int(np.bincount(row_np // r, minlength=nb).max())
               // E.E_BLK_MULTIPLE) * E.E_BLK_MULTIPLE
        phase("kernel-full", f"r_blk={r}: E_BLK={eb} slots={nb * eb} "
                             f"slots/live={nb * eb / live:.3f} "
                             f"slots/real_edges={nb * eb / real:.3f}")
    phase("kernel-full", f"plan r_blk={plan.r_blk} n_blocks={n_blocks} "
                         f"E_BLK={e_blk} slots={n_blocks * e_blk} "
                         f"live_slots={live} real_edges={real} "
                         f"padded/live={n_blocks * e_blk / live:.3f} "
                         f"payload_cols={cols} n_rows={n_rows}")
    phase("kernel-full", f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
                         f"scatter_reduce_ms={library_ms:.5f} "
                         f"bound_ms={out['bound_ms']:.5f} "
                         f"({out['bound_by']}: {n_bytes} B, {n_ops} ops) "
                         f"max_abs_err={err} (tolerance 0, int32)")
    return out


def replay_seconds(res: dict, label: str) -> None:
    """Phase 6: host time of the fold-log replay of one run's state."""
    import torch

    from repro_torch.core import rules as R

    torch.cuda.synchronize()
    t0 = time.time()
    R.reconstruct_members(res["state"], res["prob"].aux)
    phase("replay", f"{label}: log_n={int(res['state'].log_n)} "
                    f"reconstruct_members {time.time() - t0:.3f}s")


def profile_reduce(args, g, pg) -> None:
    """Phase 7: where the device time goes — the reduce run once more under
    torch.profiler; device time by kernel and the device's busy share of
    the run's wall time (union build excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import distributed as D

    a = argparse.Namespace(**{**vars(args), "algo": "reduce",
                              "schedule": "cheap-fused"})
    cfg = D.DisReduConfig(heavy_k=a.heavy_k, mode=a.mode,
                          schedule=a.schedule, backend=a.backend)
    prob = D.build_union_problem(pg, cfg.backend, cfg.r_blk, a.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, rounds = D.disredu_union(prob, cfg)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    phase("profile", f"reduce/cheap-fused/cuda rounds={rounds} "
                     f"wall={wall:.3f}s device_busy={busy_us / 1e6:.3f}s "
                     f"busy_share={busy_us / 1e6 / wall:.4f}")
    if not rows:
        phase("profile", "the profiler saw no device time: not measured")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:10]:
        phase("profile", f"{e.device_time_total / 1e3:10.3f} ms "
                         f"x{e.count:<6d} {e.key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="RGG vertices of the main-path instance")
    ap.add_argument("--rnp-n", type=int, default=1 << 16,
                    help="RGG vertices of the reduce-and-peel run")
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()

    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"the port is not beside this script ({src / 'repro_torch'})")
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    dev = torch.device("cuda")
    t_start = time.time()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} "
                    f"count={torch.cuda.device_count()} torch={torch.__version__}"
                    f" cuda={torch.version.cuda} python={sys.version.split()[0]}")

    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.launch import mwis_run

    t0 = time.time()
    K.build()
    phase("build", f"segment_fused built and loaded in {time.time() - t0:.2f}s")

    err = kernel_at_test_shapes(dev)
    if err:
        fail(f"kernel != plain version at the test shapes ({err})")

    base = mwis_run.build_parser().parse_args([
        "--family", "rgg", "--n", str(opts.n), "--p", str(opts.p),
        "--mode", "async", "--backend", "cuda", "--device", "cuda",
        "--seed", str(opts.seed),
    ])
    t0 = time.time()
    g, pg = mwis_run.prepare(base)
    phase("main", f"host preparation {time.time() - t0:.1f}s "
                  f"(per PE: L={pg.L} E={pg.E})")
    red = drive(base, g, pg, "full", True, algo="reduce",
                schedule="cheap-fused")
    ref = drive(base, g, pg, "full", False, algo="reduce",
                schedule="cheap-fused", backend="torch")
    if not same_result(red, ref):
        fail("cuda and torch backends disagree on the reduce run")
    phase("main", "cuda == torch backend: status, w, offset, log_n, rounds "
                  "and members identical")
    del ref
    rg = drive(base, g, pg, "full", True, algo="rg", schedule="edges-only")
    kfull = kernel_at_full_size(red, opts.reps)
    replay_seconds(red, "reduce/cheap-fused")
    replay_seconds(rg, "rg/edges-only")
    launches = red["launches"] + rg["launches"]
    del red, rg

    small = argparse.Namespace(**{**vars(base), "n": opts.rnp_n})
    g2, pg2 = mwis_run.prepare(small)
    rnp = drive(small, g2, pg2, "rnp-cut", True, algo="rnp",
                schedule="edges-only")
    replay_seconds(rnp, "rnp/edges-only (cut)")
    launches += rnp["launches"]

    import numpy as np

    from repro_torch.core import sequential as seq

    tiny = argparse.Namespace(**{**vars(base), "n": 3000, "algo": "greedy"})
    g3, pg3 = mwis_run.prepare(tiny)
    gr = drive(tiny, g3, pg3, "oracle", True, algo="greedy")
    w_seq, mem_seq = seq.solve_greedy(g3)
    if gr["weight"] != w_seq or not np.array_equal(
            gr["members"], np.asarray(mem_seq, bool)):
        fail("greedy on the card != sequential priority greedy")
    phase("oracle", f"greedy weight {gr['weight']} == sequential {w_seq}")
    profile_reduce(base, g, pg)

    kernels = [dict(
        name="segment_fused", route="cuda",
        source="src/repro_torch/kernels/segment_coo/csrc/segment_fused.cu",
        replaces="src/repro/kernels/segment_coo/kernel.py:159",
        launches=launches, max_abs_err=max(err, kfull["max_abs_err"]),
        ms=kfull["ms"], plain_ms=kfull["plain_ms"],
        bound_ms=kfull["bound_ms"], bound_by=kfull["bound_by"],
        library_ms=kfull["library_ms"],
    )]
    phase("done", f"total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
