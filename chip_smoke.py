#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                    # the full-size run
    python3 chip_smoke.py --n 65536          # a smaller, quicker instance

Phases, in order (any failure exits non-zero; no phase catches and
continues):

  1. device  — the card as ``nvidia-smi`` names it, with its power limit
               and its maximum SM clock (which sets the operation bounds);
  2. build   — compile the four CUDA kernels from the sources in this
               checkout, one ``nvcc`` each, all started together;
  3. kernel  — the fused segment-reduction kernel against its plain torch
               version at the test shapes (exact: all payloads are int32);
  4. ops at the micro shapes — ``segment_sum_coo``, ``common_neighbor_stats``
               and ``embedding_bag`` on CUDA tensors (each launches its
               kernel) at the reference's ``bench_kernel_micro`` shapes,
               plus bfloat16 cases with many terms a row (40 on average)
               and a bag (32), and ``common_neighbor_stats`` on windows in
               the partition's layout (ascending, nil padding last) beside
               random ones, held against their plain versions;
  5. main path — ``repro_torch.launch.mwis_run`` on RGG n = 2^20, p = 4
               (L ≈ 2^18, E ≈ 2^21 per PE), DisReduA, partitioned once:
               reduce/cheap-fused on the ``cuda`` backend, the same on the
               ``torch`` backend (must agree bit for bit), rg/edges-only on
               ``cuda``.  Kernel launch counts are reset before and read
               after each run: ``segment_fused`` must be > 0 on the
               ``cuda`` runs, the three kernels off this path 0;
  6. kernel at full size — the kernel against its plain version on the
               full-size plan with the run's real payload columns, timed
               (replayed from a CUDA graph, and called one call after
               another) beside its bound over the live slots, the bound
               that also sweeps every plan slot, and a scatter_reduce
               yardstick;
  7. wedge at full size — ``common_neighbor_stats`` on the reduce run's
               union problem (windows, edges) with its initial and its
               final state, exact against the plain version, timed;
  8. replay  — the host time of the fold-log replay
               (``rules.reconstruct_members``) of the full-size runs;
  9. rnp     — rnp/edges-only on ``cuda`` at ``--rnp-n`` (its host-driven
               peel loop does not fit the time limit at full size), then
               the kernel on its plan, timed as in phase 6;
 10. oracle  — greedy on the card equals the sequential priority greedy;
 11. profile — the reduce run again under torch.profiler: device time by
               kernel and by op, and the device's busy share of the wall
               time;
 12. segment_sum at size — graphsage-reddit ``minibatch_lg``: the fanout
               sampler's subgraph (1,024 seeds, fanouts 15 and 10: 169,984
               rows, 168,960 edges into the first 16,384 rows), D = 602 and
               128, float32 and bfloat16;
 13. embedding_bag at size — dlrm-mlperf's largest table (39,979,771 x 128)
               at ``serve_bulk`` B = 262,144, K = 1 and 4, float32 and then
               bfloat16;
 14. serve   — ``repro_torch.launch.serve --arch mwis`` on the card: the
               reference's stream of 192 requests over the three serve
               cells (4 per topology, up to serve_m: L 1,024, E 16,384),
               batches of 64, ``rg`` on ``cuda`` (verify full) and on
               ``torch`` (must agree per request bit for bit), ``greedy`` on
               ``cuda`` (each result the sequential priority greedy's),
               ``rnp`` on ``cuda`` on 48 requests (its host peel loop),
               ``rg`` on ``cuda`` with ``--descent auto`` (its serve_m
               requests one at a time through the staged solver; each
               result must equal the ``--descent off`` run's), then 4
               oversize GNM requests (n = 0.8 x 16,384) admitted through
               ``descent_xl``; 0 fallbacks, 0 verify failures,
               ``segment_fused`` launched and the three off-path kernels
               not; then the batched kernel against its plain version on a
               real stacked chunk of each cell (serve_xs, serve_s, serve_m
               x 64), timed as in phase 6;
 15. descent — ``solvers.solve_staged`` with shape descent on phase 5's
               partition (rg/edges-only on ``cuda``, ``default_ladder()``):
               members equal to phase 5's rg run bit for bit; descents,
               path and the time of each stage; ``segment_fused`` launched,
               the three off-path kernels not;
 16. resume  — the same staged solve with a checkpoint manager, killed by
               an ``InjectedFault`` after its first descent, then resumed
               from the checkpoint: members equal to phase 15's; then the
               kernel on the last rung's plan (restored from the resumed
               run's last checkpoint, the payload columns of the rung's
               first sweep) against its plain version, timed as in phase 6;
 17. dist    — the per-PE path (``launch.mesh.run_shard_map``: one spawned
               rank of a ``torch.distributed`` group a PE): four gloo
               ranks, all on the one card (NCCL refuses two ranks on one
               device), spawned once, run reduce/cheap-fused with the a2a
               and the allgather exchange and rg/edges-only on phase 5's
               partition, rnp/edges-only at ``--dist-rnp-n``, and reduce
               and rg at ``DIST_LOCAL_N``.  The per-PE sweeps are
               rank-local, as the reference's shard_map's are, so rounds
               and even the reduced graph may differ from the union
               path's (the CPU tests hold the per-PE path to the
               reference's shard_map bit for bit): each run prints the
               union run's rounds, offset, statuses and members beside
               its own; the two exchanges agree in every output at full
               size; the smaller runs equal the same four ranks on the
               CPU in every output, rounds included; members are
               independent; every rank ran one round count.  Then one
               NCCL rank (p = 1, rg) equal to the union run; every rank
               launched ``segment_fused`` and no other kernel; then the
               kernel on rank 0's plan (its row of ``shard_map_arrays``)
               with the first sweep's columns, timed as in phase 6.  Four
               processes share one card and the host, so its seconds are
               no multi-GPU time.

Phases 4, 7, 12 and 13 reset each op's launch count just before its calls
and read it just after (it must be > 0), then time the kernel, its plain
version and, where one exists, the single PyTorch call that computes the
same function, beside the least time the card could take.

Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
Every row's ``ms`` and ``library_ms`` are wrapper calls timed one after
another with CUDA events; the ``segment_fused`` rows add their CUDA-graph
times and their bound over live slots (``FUSED_EXTRA``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM memory rate (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
#: Operations an SM retires per clock outside the tensor cores, by class
#: (Hopper white paper: 128 FP32 lanes, 64 INT32 lanes a SM).  An FMA
#: counts once.  The rates are these times the SMs and the card's maximum
#: SM clock (``CARD``, filled from the device at start).
LANES_PER_SM_CLOCK = {"int32": 64, "fp32_add": 128, "fp32_fma": 128}
CARD = {"sms": 0, "max_sm_hz": 0.0}

#: graphsage-reddit ``minibatch_lg`` (src/repro/configs/base.py): 1,024
#: seed nodes sampled at fanouts (15, 10) give 169,984 nodes and 168,960
#: edges; payload widths are Reddit's 602 features (layer 1) and d_hidden
#: 128 (layer 2); r_blk is the reference's default.
SEGMENT_SUM_SIZE = dict(seeds=1024, fanouts=(15, 10), n_rows=169_984,
                        n_edges=168_960, widths=(602, 128), r_blk=8)
#: dlrm-mlperf's largest table (src/repro/models/dlrm.py) at ``serve_bulk``.
EMBEDDING_BAG_SIZE = dict(V=39_979_771, D=128, B=262_144, bags=(1, 4))

#: RGG vertices of phase 17's NCCL run (world 1, p = 1).
DIST_NCCL_N = 1 << 14
#: RGG vertices of phase 17's reduce and rg runs held against the same
#: ranks on the CPU: at this size the per-PE rounds (rank-local sweeps)
#: differ from the union's.
DIST_LOCAL_N = 1 << 16

#: The TPU kernel each CUDA kernel replaces (the sources are the kernel
#: modules' ``LIBS``).
REPLACES = {
    "segment_fused": "src/repro/kernels/segment_coo/kernel.py:159",
    "segment_sum": "src/repro/kernels/segment_coo/kernel.py:62",
    "wedge_intersect": "src/repro/kernels/wedge_intersect/kernel.py:43",
    "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:44",
}
#: Keys the kernels line's ``segment_fused`` rows carry beside the common
#: ones (``fused_at``): the CUDA-graph times and the bound over live slots.
FUSED_EXTRA = ("graph_ms", "library_graph_ms", "live_bound_ms")


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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the time the card takes, without the host's cost
    of launching each call (a call through a Python wrapper can cost the
    host more than its kernel costs the card).  Warms up on a side stream
    first, as capture requires."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
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


def launch_counts() -> dict:
    from repro_torch import kernels

    return {name: kernels.launch_count(name) for name in REPLACES}


def run_op(kernel: str, call):
    """One call of a public op on CUDA tensors, every launch count reset
    just before and read just after; fails unless ``kernel`` launched.
    Returns (result, launches)."""
    import torch

    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    n = launch_counts()[kernel]
    if n <= 0:
        fail(f"the op on CUDA tensors never launched {kernel}")
    return out, n


def bound(n_bytes: float, n_ops: float, op_class: str) -> tuple[float, str]:
    """Least time the card could take (ms) and what sets it: the bytes at
    the HBM rate or the operations at their class's rate."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_per_s = (LANES_PER_SM_CLOCK[op_class] * CARD["sms"]
                 * CARD["max_sm_hz"])
    ops_ms = n_ops / ops_per_s * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by


def timings(label: str, kernel, plain, library, reps: int, n_bytes: float,
            n_ops: float, op_class: str) -> dict:
    """CUDA-event times of the kernel, its plain version and (where there
    is one) the single PyTorch call computing the same function, beside the
    bound."""
    out = dict(ms=cuda_ms(kernel, reps),
               plain_ms=cuda_ms(plain, max(reps // 4, 2), warmup=1),
               library_ms=None if library is None else cuda_ms(library, reps))
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_ops, op_class)
    lib = ("none" if library is None
           else f"{out['library_ms']:.5f}")
    phase(label, f"kernel_ms={out['ms']:.5f} plain_ms={out['plain_ms']:.5f} "
                 f"library_ms={lib} bound_ms={out['bound_ms']:.5f} "
                 f"({out['bound_by']}: {int(n_bytes)} B, {int(n_ops)} "
                 f"{op_class} ops) "
                 f"bound/kernel={out['bound_ms'] / out['ms']:.4f}")
    return out


def check_segment_sum(got, data, perm, lrow, n_rows: int, r_blk: int,
                      label: str) -> float:
    """Kernel vs plain version (both sum in float32 and round once; the
    plain version on the card adds by atomics in any order).  Tolerance:
    float32, 1e-5 of the row's sum of |x| per column; bfloat16, one ulp of
    the result (2^-7 relative) on top.  Returns the max abs error."""
    import torch

    from repro_torch.kernels.segment_coo.ops import segment_sum_plain

    want = segment_sum_plain(data, perm, lrow, n_rows, r_blk=r_blk).float()
    scale = segment_sum_plain(data.float().abs(), perm, lrow, n_rows,
                              r_blk=r_blk)
    tol, what = 1e-5 * scale, "1e-5 sum|x|"
    if data.dtype == torch.bfloat16:
        tol, what = tol + want.abs() * 2.0 ** -7, what + " + 2^-7 |want|"
    diff = (got.float() - want).abs()
    err = float(diff.max())
    phase(label, f"max_abs_err={err:.3e} (tolerance {what})")
    if got.dtype != data.dtype or not bool((diff <= tol).all()):
        fail(f"{label}: segment_sum kernel outside its tolerance ({err})")
    return err


def check_wedge(got, args, label: str) -> int:
    """Kernel vs plain version: all int32, exact."""
    from repro_torch.kernels.wedge_intersect.ref import (
        common_neighbor_stats_ref,
    )

    err = max_abs_err(got, common_neighbor_stats_ref(*args))
    phase(label, f"max_abs_err={err} (tolerance 0, int32)")
    if err:
        fail(f"{label}: wedge_intersect kernel != plain version ({err})")
    return err


def check_embedding_bag(got, table, idx, wgt, label: str) -> float:
    """Kernel vs plain version (both sum in float32 and round once).
    Tolerance: float32, the JAX test's 1e-5 (rtol = atol); bfloat16, one
    ulp of the result (2^-7 relative) on top of 1e-5 of the bag's sum of
    |w x| per column, which a kernel that added in bfloat16 would exceed
    at many terms a bag.  Returns the max abs error."""
    import torch

    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    want = embedding_bag_ref(table, idx, wgt).float()
    if table.dtype == torch.float32:
        tol, what = 1e-5 + 1e-5 * want.abs(), "1e-5 rtol+atol"
    else:
        scale = embedding_bag_ref(table.float().abs(), idx, wgt.abs())
        tol = 1e-5 * scale + want.abs() * 2.0 ** -7
        what = "1e-5 sum|w x| + 2^-7 |want|"
    diff = (got.float() - want).abs()
    err = float(diff.max())
    phase(label, f"max_abs_err={err:.3e} (tolerance {what})")
    if got.dtype != table.dtype or not bool((diff <= tol).all()):
        fail(f"{label}: embedding_bag kernel outside its tolerance ({err})")
    return err


def ops_at_micro_shapes(dev, seed: int) -> dict:
    """Phase 4: the three ops off the MWIS path on CUDA tensors at the
    reference's ``bench_kernel_micro`` shapes, against their plain
    versions; returns {kernel: {launches, max_abs_err}}."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.segment_coo.ops import (
        pack_blocks, segment_sum_coo,
    )
    from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats

    rng = np.random.default_rng(seed)
    rec = {}
    n, e, d = 5000, 40000, 128
    row = rng.integers(0, n, size=e).astype(np.int32)
    perm, lrow, _ = pack_blocks(row, n, r_blk=8)
    perm = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lrow = torch.from_numpy(lrow).to(dev)
    data = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(dev)
    got, k = run_op("segment_sum", lambda: segment_sum_coo(
        data, perm, lrow, n, r_blk=8))
    err = check_segment_sum(got, data, perm, lrow, n, 8,
                            f"micro segment_sum n_rows={n} E={e} D={d} f32")
    rec["segment_sum"] = dict(launches=k, max_abs_err=err)
    # many terms a row (40 on average) in bfloat16: a kernel that added in
    # bfloat16 would fall outside the one-ulp tolerance
    n = 1000
    row = rng.integers(0, n, size=e).astype(np.int32)
    perm, lrow, _ = pack_blocks(row, n, r_blk=8)
    perm = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lrow = torch.from_numpy(lrow).to(dev)
    data = data.to(torch.bfloat16)
    got, k = run_op("segment_sum", lambda: segment_sum_coo(
        data, perm, lrow, n, r_blk=8))
    err = check_segment_sum(got, data, perm, lrow, n, 8,
                            f"micro segment_sum n_rows={n} E={e} D={d} bf16")
    rec["segment_sum"]["launches"] += k
    rec["segment_sum"]["max_abs_err"] = max(err,
                                            rec["segment_sum"]["max_abs_err"])

    V, E, D = 1000, 20000, 16
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, V, size=(V, D)).astype(np.int32),
        rng.integers(0, 200, size=V).astype(np.int32),
        rng.integers(0, 2, size=V).astype(bool),
        rng.integers(0, V, size=E).astype(np.int32),
        rng.integers(0, V, size=E).astype(np.int32)))
    got, k = run_op("wedge_intersect", lambda: common_neighbor_stats(*args))
    tag = f"micro wedge_intersect V={V} E={E} D={D} random windows"
    err = check_wedge(got, args, tag)
    rec["wedge_intersect"] = dict(launches=k, max_abs_err=err)
    # the partition's layout: each window ascending, nil (the last vertex,
    # active here so nil entries count) padding last; edges sorted by row
    nil = V - 1
    window = np.full((V, D), nil, dtype=np.int32)
    for v, m in enumerate(rng.integers(0, D + 1, size=V)):
        window[v, :m] = np.sort(rng.choice(nil, size=m, replace=False))
    active = rng.integers(0, 2, size=V).astype(bool)
    active[nil] = True
    row, col = (rng.integers(0, V, size=E).astype(np.int32) for _ in "rc")
    order = np.lexsort((col, row))
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        window, rng.integers(0, 200, size=V).astype(np.int32), active,
        row[order], col[order]))
    got, k = run_op("wedge_intersect", lambda: common_neighbor_stats(*args))
    tag = f"micro wedge_intersect V={V} E={E} D={D} sorted windows"
    err = check_wedge(got, args, tag)
    rec["wedge_intersect"]["launches"] += k
    rec["wedge_intersect"]["max_abs_err"] = max(
        err, rec["wedge_intersect"]["max_abs_err"])

    V, B, K_, D = 100_000, 8192, 4, 128
    table, idx, wgt = (torch.from_numpy(a).to(dev) for a in (
        rng.normal(size=(V, D)).astype(np.float32),
        rng.integers(0, V, size=(B, K_)).astype(np.int32),
        rng.normal(size=(B, K_)).astype(np.float32)))
    got, k = run_op("embedding_bag", lambda: embedding_bag(table, idx, wgt))
    err = check_embedding_bag(
        got, table, idx, wgt,
        f"micro embedding_bag V={V} B={B} K={K_} D={D} f32")
    rec["embedding_bag"] = dict(launches=k, max_abs_err=err)
    # 32 terms a bag in bfloat16 (see check_embedding_bag)
    K_ = 32
    table = table.to(torch.bfloat16)
    idx, wgt = (torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, V, size=(B, K_)).astype(np.int32),
        rng.normal(size=(B, K_)).astype(np.float32)))
    got, k = run_op("embedding_bag", lambda: embedding_bag(table, idx, wgt))
    err = check_embedding_bag(
        got, table, idx, wgt,
        f"micro embedding_bag V={V} B={B} K={K_} D={D} bf16")
    rec["embedding_bag"]["launches"] += k
    rec["embedding_bag"]["max_abs_err"] = max(
        err, rec["embedding_bag"]["max_abs_err"])
    return rec


def wedge_at_full_size(res: dict, reps: int) -> dict:
    """Phase 7: ``common_neighbor_stats`` on the full-size union problem
    with the reduce run's initial and final state (active = UNDECIDED),
    exact against the plain version; returns {launches, max_abs_err} and
    the timings on the initial state."""
    from repro_torch.core import rules as R
    from repro_torch.kernels.wedge_intersect import kernel as WK
    from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
    from repro_torch.kernels.wedge_intersect.ref import (
        common_neighbor_stats_ref,
    )

    prob, aux = res["prob"], res["prob"].aux
    init = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    n_edges = aux.row.shape[0]
    n_vertices, d = aux.window.shape
    merge_len = (aux.gid[aux.window.long()] >= 0).sum(1)
    out = dict(launches=0, max_abs_err=0)
    for label, st in (("initial", init), ("final", res["state"])):
        active = st.status == R.UNDECIDED
        args = (aux.window, st.w, active, aux.row, aux.col)
        got, k = run_op("wedge_intersect",
                        lambda: common_neighbor_stats(*args))
        out["launches"] += k
        tag = f"wedge-full {label} state"
        out["max_abs_err"] = max(out["max_abs_err"],
                                 check_wedge(got, args, tag))
        phase(tag, f"E={n_edges} V={n_vertices} D={d} "
                   f"active={int(active.sum())} "
                   f"sum_K={int(got[1].long().sum())}")
        # least bytes: row, col and both outputs per edge; window,
        # weights and activity per vertex.  Least operations: the windows
        # are sorted with the nil padding last (``core/partition.py``), so
        # a merge of W(row) and W(col) takes one int32 compare per real
        # entry of the two, not the TPU kernel's D x D
        t = timings(tag, lambda: WK.wedge_intersect(*args),
                    lambda: common_neighbor_stats_ref(*args), None, reps,
                    16 * n_edges + n_vertices * (4 * d + 5),
                    int(merge_len[aux.row.long()].sum()
                        + merge_len[aux.col.long()].sum()), "int32")
        if label == "initial":
            out.update(t)
    return out


def drive(args, g, pg, label: str, need_launches: bool, **over) -> dict:
    """One main-path run through ``mwis_run.run``, launch counts reset just
    before and read just after."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import mwis_run

    a = argparse.Namespace(**{**vars(args), **over})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = mwis_run.run(a, g, pg)
    torch.cuda.synchronize()
    counts = launch_counts()
    res["launches"] = counts.pop("segment_fused")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    phase("main", f"{label}: {a.algo}/{a.schedule}/{a.backend} "
                  f"rounds={res['rounds']} seconds={res['seconds']:.3f} "
                  f"(union build {res['build_seconds']:.3f}) "
                  f"offset={int(res['state'].offset)} "
                  f"weight={res.get('weight')} "
                  f"members={int(res['members'].sum())} "
                  f"kernel_launches={res['launches']} "
                  f"off_path_kernel_launches={sum(counts.values())} "
                  f"peak_device_gb={res['peak_gb']:.2f}")
    if need_launches and res["launches"] <= 0:
        fail(f"{label}: the cuda backend never launched the kernel")
    if not need_launches and res["launches"] != 0:
        fail(f"{label}: the kernel launched on a non-cuda backend")
    if any(counts.values()):
        fail(f"{label}: a kernel off the MWIS path launched: {counts}")
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


def fused_args(prob, state, schedule: str) -> dict:
    """The kernel's keyword arguments for one sweep of ``schedule`` in
    ``state``: the engine's own payload columns (S/deg sums, M/only maxes,
    the wbits/wnh ORs where the schedule needs window bits), the plan's
    r_blk and live extents, the window cap as or_nbits."""
    from repro_torch.core import engine as E

    plan, aux = prob.plan, prob.aux
    req = E.schedule_requires(E.SCHEDULES[schedule])
    _, _, dsum, dmax, dor = E.ctx_payloads(state, aux, req, window_bits=True,
                                           plan=plan)
    return dict(r_blk=plan.r_blk, data_sum=dsum, data_max=dmax, data_or=dor,
                or_nbits=aux.window.shape[1], extent=plan.extent)


def fused_at(label: str, prob, kw: dict, reps: int) -> dict:
    """The kernel on a real plan (unbatched or stacked) against its plain
    version, exactly, then timed.  ``ms`` and ``library_ms`` keep PR 15's
    yardstick: the wrapper called one call after another, timed with CUDA
    events (host launch cost included where the host is slower than the
    card).  ``graph_ms`` and ``library_graph_ms`` replay the same calls
    from a CUDA graph (the card's time alone).  The library call is
    ``scatter_reduce`` over the union rows for the sum / max / min columns
    (a yardstick the port never calls; torch has no OR reduce, so the OR
    columns are left out of it).  Beside them two bounds: ``bound_ms``, PR
    15's, reads lrow over every plan slot; ``live_bound_ms`` reads only
    what the kernel must (each row block's extent, a live slot's row and
    edge id, the payloads once, the outputs once)."""
    import torch

    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.kernels.segment_coo.ops import segment_fused_plain

    plan, aux = prob.plan, prob.aux
    batch = plan.edge_perm.shape[0] if plan.edge_perm.dim() == 3 else 1
    total = aux.gid.shape[0]
    n_rows = total // batch
    plain_kw = {k: v for k, v in kw.items() if k != "extent"}
    got = K.segment_fused(plan.edge_perm, plan.lrow, n_rows, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, segment_fused_plain(plan.edge_perm, plan.lrow,
                                               n_rows, **plain_kw))
    if err:
        fail(f"{label}: kernel != plain version ({err})")
    row = aux.row.long()
    i32 = torch.iinfo(torch.int32)
    reduced = [(k, d, how, fill) for k, (d, how, fill) in enumerate((
        (kw.get("data_sum"), "sum", 0), (kw.get("data_max"), "amax", i32.min),
        (kw.get("data_min"), "amin", i32.max))) if d is not None]

    def library():
        return [torch.full((total, d.shape[1]), fill, dtype=torch.int32,
                           device=row.device).scatter_reduce_(
                               0, row[:, None].expand_as(d), d, how)
                for _, d, how, fill in reduced]

    lib = library()
    torch.cuda.synchronize()
    if not all(torch.equal(x, got[k]) for x, (k, *_) in zip(lib, reduced)):
        fail(f"{label}: the scatter_reduce yardstick disagrees with the "
             f"kernel")

    groups = [kw.get(k) for k in ("data_sum", "data_max", "data_min",
                                  "data_or")]
    cols = sum(d.shape[1] for d in groups if d is not None)
    n_edges = next(d.shape[0] for d in groups if d is not None)
    e_blk = plan.lrow.shape[-1]
    n_blocks = plan.lrow.numel() // e_blk
    live = int(((plan.lrow >= 0) & (plan.lrow < plan.r_blk)).sum())
    ext = plan.extent.long()
    plan_bytes = 4 * (n_blocks * e_blk + live + n_edges * cols
                      + total * cols)
    live_bytes = 4 * (n_blocks + 2 * live + n_edges * cols + total * cols)
    n_ops = live * cols  # int32 add / max / min / or

    def kernel():
        return K.segment_fused(plan.edge_perm, plan.lrow, n_rows, **kw)

    out = dict(ms=cuda_ms(kernel, reps), graph_ms=graph_ms(kernel, reps),
               plain_ms=cuda_ms(lambda: segment_fused_plain(
                   plan.edge_perm, plan.lrow, n_rows, **plain_kw),
                   max(reps // 10, 2), warmup=1),
               library_ms=cuda_ms(library, reps),
               library_graph_ms=graph_ms(library, reps), max_abs_err=err)
    out["bound_ms"], out["bound_by"] = bound(plan_bytes, n_ops, "int32")
    out["live_bound_ms"], live_by = bound(live_bytes, n_ops, "int32")
    phase(label, f"plan: batch={batch} n_blocks={n_blocks // batch} "
                 f"r_blk={plan.r_blk} E_BLK={e_blk} "
                 f"slots={n_blocks * e_blk} live_slots={live} "
                 f"extent_max={int(ext.max())} "
                 f"extent_mean={float(ext.float().mean()):.1f} "
                 f"blocks_over_1024={int((ext > 1024).sum())} "
                 f"edge_rows={n_edges} out_rows={total} payload_cols={cols} "
                 f"max_abs_err={err} (tolerance 0, int32)")
    phase(label, f"kernel_ms={out['ms']:.5f} (wrapper, one call after "
                 f"another) graph_ms={out['graph_ms']:.5f} (CUDA graph) "
                 f"plain_ms={out['plain_ms']:.5f} "
                 f"scatter_reduce_ms={out['library_ms']:.5f} (called; "
                 f"{out['library_graph_ms']:.5f} CUDA graph)")
    phase(label, f"bound_live_ms={out['live_bound_ms']:.5f} ({live_by}: "
                 f"{live_bytes} B, {n_ops} int32 ops) "
                 f"bound_live/graph={out['live_bound_ms'] / out['graph_ms']:.4f} "
                 f"bound_live/kernel={out['live_bound_ms'] / out['ms']:.4f} "
                 f"bound_plan_ms={out['bound_ms']:.5f} ({out['bound_by']}: "
                 f"{plan_bytes} B) "
                 f"bound_plan/kernel={out['bound_ms'] / out['ms']:.4f} "
                 f"kernel/scatter_reduce={out['ms'] / out['library_ms']:.4f} "
                 f"graph/scatter_reduce_graph="
                 f"{out['graph_ms'] / out['library_graph_ms']:.4f}")
    return out


def kernel_at_full_size(res: dict, reps: int) -> dict:
    """Phase 6: the kernel on the full-size plan with the real payload
    columns of the reduce run's final state (S/deg sums, M/only maxes,
    wbits/wnh ORs), against its plain version; times and bounds, and the
    padding each candidate r_blk would give the plan."""
    import numpy as np

    from repro_torch.core import engine as E

    prob = res["prob"]
    aux = prob.aux
    row_np = aux.row.cpu().numpy()
    n_rows = aux.gid.shape[0]
    live = row_np.shape[0]
    real = int((aux.gid[aux.row.long()] >= 0).sum())
    for r in E.R_BLK_CANDIDATES:  # the packing census autotune chose from
        nb = -(-n_rows // r)
        eb = -(-int(np.bincount(row_np // r, minlength=nb).max())
               // E.E_BLK_MULTIPLE) * E.E_BLK_MULTIPLE
        phase("kernel-full", f"r_blk={r}: E_BLK={eb} slots={nb * eb} "
                             f"slots/live={nb * eb / live:.3f} "
                             f"slots/real_edges={nb * eb / real:.3f}")
    phase("kernel-full", f"real_edges={real}")
    return fused_at("kernel-full", prob,
                    fused_args(prob, res["state"], "cheap-fused"), reps)


def kernel_at_rnp_plan(res: dict, reps: int) -> dict:
    """Phase 9: the kernel on rnp's plan (the most launches of any shape)
    with the edges-only sweep's columns of its final state; times and
    bounds."""
    return fused_at("kernel-rnp", res["prob"],
                    fused_args(res["prob"], res["state"], "edges-only"), reps)


def replay_seconds(res: dict, label: str) -> None:
    """Phase 8: host time of the fold-log replay of one run's state."""
    import torch

    from repro_torch.core import rules as R

    torch.cuda.synchronize()
    t0 = time.time()
    R.reconstruct_members(res["state"], res["prob"].aux)
    phase("replay", f"{label}: log_n={int(res['state'].log_n)} "
                    f"reconstruct_members {time.time() - t0:.3f}s")


def reduce_problem(args, pg):
    """The full-size union problem and config of the reduce run, for the
    profile."""
    from repro_torch.core import distributed as D

    cfg = D.DisReduConfig(heavy_k=args.heavy_k, mode=args.mode,
                          schedule="cheap-fused", backend=args.backend)
    return D.build_union_problem(pg, cfg.backend, cfg.r_blk, args.device), cfg


def device_profile(label: str, fn, top: int = 15) -> dict:
    """Run ``fn`` once under torch.profiler: device time by kernel and by
    launching op, and the device's busy share of the call's wall time.
    Returns the aten ops by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    phase("profile", f"{label} wall={wall:.3f}s "
                     f"device_busy={busy_us / 1e6:.3f}s "
                     f"busy_share={busy_us / 1e6 / wall:.4f}")
    if not rows:
        phase("profile", "the profiler saw no device time: not measured")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:top]:
        phase("profile", f"{e.device_time_total / 1e3:10.3f} ms "
                         f"x{e.count:<6d} {e.key[:90]}")
    # the same device time by the torch op that launched it (an op's time
    # includes the ops it calls, so nested rows overlap)
    ops = [e for e in prof.key_averages()
           if e.key.startswith("aten::")
           and getattr(e, "device_time_total", 0) > 0]
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:top]:
        phase("profile", f"op {e.device_time_total / 1e3:10.3f} ms "
                         f"x{e.count:<6d} {e.key}")
    return {e.key: e for e in ops}


def profile_reduce(prob, cfg) -> None:
    """Phase 11: where the device time goes — the reduce run once more under
    torch.profiler (union build excluded)."""
    from repro_torch.core import distributed as D

    by_key = device_profile("reduce/cheap-fused/cuda",
                            lambda: D.disredu_union(prob, cfg))
    # the ops the rules' scatters and the exchange's board fills go through
    for key in ("aten::index_add_", "aten::scatter_reduce_",
                "aten::index_put_", "aten::nonzero"):
        e = by_key.get(key)
        phase("profile", f"scatter op {key}: " + (
            "no device time" if e is None else
            f"{e.device_time_total / 1e3:.3f} ms x{e.count}"))


def sampled_targets(seeds: int, fanouts: tuple[int, ...]) -> np.ndarray:
    """The target row of every edge of a fanout-sampled subgraph, in the
    layout of the reference's sampler (src/repro/graphs/sampler.py): seeds
    are rows 0..seeds-1, each hop's new nodes follow in order, and each
    node of a frontier takes ``f`` in-edges from the next hop.  No sampled
    neighbour repeats, which is what the padded shapes of ``minibatch_lg``
    hold room for."""
    import numpy as np

    targets, first, frontier = [], 0, seeds
    for f in fanouts:
        targets.append(np.repeat(np.arange(first, first + frontier,
                                           dtype=np.int32), f))
        first, frontier = first + frontier, frontier * f
    return np.concatenate(targets)


def segment_sum_at_size(dev, seed: int, reps: int) -> dict:
    """Phase 12: ``segment_sum_coo`` at graphsage-reddit ``minibatch_lg``
    (src/repro/configs/base.py): GraphSAGE's neighbour sum over the sampled
    subgraph of 1,024 seeds at fanouts (15, 10) — 169,984 rows, 168,960
    edges, each summed into its target (rows 0..1,023 take 15 each, rows
    1,024..16,383 take 10, the 153,600 nodes of the last hop none) — at
    r_blk 8, the reference's default.  The edge payloads (the source
    features the model gathers before the sum) are drawn from the seed.
    D = 602 (Reddit features, layer 1) and 128 (d_hidden, layer 2), float32
    and bfloat16; returns {launches, max_abs_err} and the timings of
    D = 602 float32."""
    import numpy as np
    import torch

    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.kernels.segment_coo.ops import (
        pack_blocks, segment_sum_coo, segment_sum_plain,
    )

    n_rows, n_edges, r_blk = (SEGMENT_SUM_SIZE[k]
                              for k in ("n_rows", "n_edges", "r_blk"))
    row = sampled_targets(SEGMENT_SUM_SIZE["seeds"],
                          SEGMENT_SUM_SIZE["fanouts"])
    if row.shape[0] != n_edges or SEGMENT_SUM_SIZE["seeds"] + row.shape[0] \
            != n_rows:
        fail(f"the sampled layout ({row.shape[0]} edges) is not "
             f"minibatch_lg's ({n_edges} edges, {n_rows} nodes)")
    perm, lrow, e_blk = pack_blocks(row, n_rows, r_blk=r_blk)
    n_blocks = perm.shape[0]
    perm = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lrow = torch.from_numpy(lrow).to(dev)
    row_t = torch.from_numpy(row).to(dev).long()
    phase("segment_sum-size", f"n_rows={n_rows} E={n_edges} r_blk={r_blk} "
                              f"n_blocks={n_blocks} E_BLK={e_blk} "
                              f"slots/edges={n_blocks * e_blk / n_edges:.3f} "
                              f"empty_blocks="
                              f"{int((lrow == r_blk).all(1).sum())}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = dict(launches=0, max_abs_err=0.0)
    for d in SEGMENT_SUM_SIZE["widths"]:
        x32 = torch.randn((n_edges, d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            data = x32.to(dtype)
            tag = f"segment_sum-size D={d} {str(dtype)[6:]}"
            got, k = run_op("segment_sum", lambda: segment_sum_coo(
                data, perm, lrow, n_rows, r_blk=r_blk))
            out["launches"] += k
            out["max_abs_err"] = max(out["max_abs_err"], check_segment_sum(
                got, data, perm, lrow, n_rows, r_blk, tag))

            def library():  # yardstick only: the port never calls it
                return torch.zeros((n_rows, d), dtype=dtype,
                                   device=dev).index_add_(0, row_t, data)

            lib_err = float((library().float() - got.float()).abs().max())
            phase(tag, f"index_add_ yardstick vs kernel max_abs_err="
                       f"{lib_err:.3e} (not a check: it adds in the data "
                       f"type by atomics)")
            es = data.element_size()
            # least bytes: lrow over every slot, edge_perm and the payload
            # row of each edge (all live), the [n_rows, d] output; ops: one
            # float32 add per payload element
            t = timings(tag, lambda: K.segment_sum(data, perm, lrow, n_rows,
                                                   r_blk=r_blk),
                        lambda: segment_sum_plain(data, perm, lrow, n_rows,
                                                  r_blk=r_blk),
                        library, reps,
                        4 * n_blocks * e_blk + 4 * n_edges
                        + es * d * (n_edges + n_rows),
                        n_edges * d, "fp32_add")
            if d == SEGMENT_SUM_SIZE["widths"][0] and dtype == torch.float32:
                out.update(t)
        del x32, data
    torch.cuda.synchronize()
    return out


def embedding_bag_at_size(dev, seed: int, reps: int) -> dict:
    """Phase 13: ``embedding_bag`` on dlrm-mlperf's largest table
    (src/repro/models/dlrm.py: V = 39,979,771, D = 128) at ``serve_bulk``
    (B = 262,144), K = 1 (the model's single-hot lookup) and 4, uniform
    indices from the seed; float32 (20.5 GB), then bfloat16 once the
    float32 table is freed.  Returns {launches, max_abs_err} and the
    timings of float32, K = 1."""
    import torch

    from repro_torch.kernels.embedding_bag import kernel as EK
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    V, D, B = (EMBEDDING_BAG_SIZE[k] for k in "VDB")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = dict(launches=0, max_abs_err=0.0)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((V, D), generator=gen, device=dev, dtype=dtype)
        for k_bag in EMBEDDING_BAG_SIZE["bags"]:
            idx = torch.randint(0, V, (B, k_bag), generator=gen, device=dev,
                                dtype=torch.int32)
            wgt = torch.randn((B, k_bag), generator=gen, device=dev)
            tag = f"embedding_bag-size K={k_bag} {str(dtype)[6:]}"
            got, k = run_op("embedding_bag",
                            lambda: embedding_bag(table, idx, wgt))
            out["launches"] += k
            out["max_abs_err"] = max(out["max_abs_err"], check_embedding_bag(
                got, table, idx, wgt, tag))
            idx_l, wgt_t = idx.long(), wgt.to(dtype)

            def library():  # yardstick only: the port never calls it
                return torch.nn.functional.embedding_bag(
                    idx_l, table, mode="sum", per_sample_weights=wgt_t)

            lib_err = float((library().float() - got.float()).abs().max())
            phase(tag, f"F.embedding_bag yardstick vs kernel max_abs_err="
                       f"{lib_err:.3e} (not a check: its weights are in the "
                       f"table's type)")
            es = table.element_size()
            # least bytes: one table row, one index and one weight per
            # lookup, one output row per bag; ops: one float32 FMA per
            # looked-up element
            t = timings(tag, lambda: EK.embedding_bag(table, idx, wgt),
                        lambda: embedding_bag_ref(table, idx, wgt),
                        library, reps,
                        B * k_bag * (D * es + 8) + B * D * es,
                        B * k_bag * D, "fp32_fma")
            if (dtype == torch.float32
                    and k_bag == EMBEDDING_BAG_SIZE["bags"][0]):
                out.update(t)
        del table
        torch.cuda.empty_cache()
    return out


def serve_run(opts, label: str, need_launches: bool, **over) -> dict:
    """One pass of ``repro_torch.launch.serve``'s path (its warm-up, timed
    and weight passes, its printed lines) on the card, launch counts reset
    just before and read just after; fails on a fallback, a verify failure,
    a failed request or a kernel launch off the serving path."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import serve as serve_cli

    argv = ["--arch", "mwis", "--batch", "64", "--device", "cuda",
            "--seed", str(opts.seed)]
    for k, v in over.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    args = serve_cli.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    out = serve_cli.serve_mwis(args)
    torch.cuda.synchronize()
    out["seconds"] = time.time() - t0
    counts = launch_counts()
    out["launches"] = counts.pop("segment_fused")
    st = out["service"].stats
    tp = out["throughput"]
    phase("serve", f"{label}: {args.algo}/{args.backend} "
                   f"requests={tp['instances']} "
                   f"inst_per_s={tp['instances_per_sec']} "
                   f"batches={tp['batches']} p50_ms={tp['p50_ms']} "
                   f"p99_ms={tp['p99_ms']} max_ms={tp['max_ms']} "
                   f"stage_p50_ms={st['stage_p50_ms']} "
                   f"cache_hits={st['cache_hits']} "
                   f"cache_misses={st['cache_misses']} "
                   f"e_blk_hwm={st['e_blk_hwm']} "
                   f"kernel_launches={out['launches']} "
                   f"seconds={out['seconds']:.2f}")
    if st["fallbacks"] or st["backend_active"] != args.backend:
        fail(f"{label}: the service left its backend ({st['events']})")
    if st["verify_failures"] or any(not r.ok for r in out["results"]):
        fail(f"{label}: a request failed or did not verify")
    if need_launches and out["launches"] <= 0:
        fail(f"{label}: the cuda backend never launched the kernel")
    if not need_launches and out["launches"] != 0:
        fail(f"{label}: the kernel launched on a non-cuda backend")
    if any(counts.values()):
        fail(f"{label}: a kernel off the serving path launched: {counts}")
    return out


def serve_descent(opts, off: dict) -> dict:
    """Phase 14's descent run: the same stream with ``--descent auto``
    (each request equal to the ``--descent off`` run ``off``), then 4
    oversize requests admitted through ``descent_xl``, verified."""
    import numpy as np

    from repro_torch.core import serve as SV
    from repro_torch.graphs.generators import gnm

    dsc = serve_run(opts, "rg cuda descent=auto", True, algo="rg",
                    backend="cuda", requests=192, verify="full",
                    descent="auto")
    for i, (a, b) in enumerate(zip(dsc["results"], off["results"])):
        if a.weight != b.weight or not np.array_equal(a.members, b.members):
            fail(f"serve: descent auto and off disagree on request {i}")
    svc = dsc["service"]
    st = svc.stats
    if st["descent_solves"] <= 0:
        fail("serve: descent auto sent no request through the staged path")
    tp, tp_off = dsc["throughput"], off["throughput"]
    phase("serve", f"rg cuda descent auto == off: members and weight of "
                   f"all {len(dsc['results'])} requests identical; "
                   f"descent_solves={st['descent_solves']} "
                   f"descents={st['descents']} "
                   f"cache_descent_hits={st['cache_descent_hits']} "
                   f"cache_descent_misses={st['cache_descent_misses']}; "
                   f"inst_per_s={tp['instances_per_sec']} (off "
                   f"{tp_off['instances_per_sec']}) p50_ms={tp['p50_ms']} "
                   f"(off {tp_off['p50_ms']}) p99_ms={tp['p99_ms']} (off "
                   f"{tp_off['p99_ms']})")
    xl = next(c for c in SV.descent_entry_cells() if c.name == "descent_xl")
    n = int(0.8 * xl.L)
    m = min(2 * n, xl.E // 4)
    big = [gnm(n, m, seed=opts.seed + k) for k in range(4)]
    if any(SV.bucket_for(g.n, g.num_directed_edges,
                         svc.descent_cells).name != xl.name for g in big):
        fail("serve: the oversize requests do not enter at descent_xl")
    before = dict(st)
    t0 = time.time()
    res = svc.solve_batch(big)
    dt = time.time() - t0
    st = svc.stats
    grew = {k: st[k] - before[k] for k in (
        "oversize_admitted", "descent_solves", "descents",
        "verify_checked", "verify_failures", "solve_errors", "fallbacks")}
    phase("serve", f"oversize n={n} m={m} x {len(big)} via descent_xl: "
                   f"{grew} weights={[r.weight for r in res]} "
                   f"seconds={dt:.2f}")
    if (grew["oversize_admitted"] != len(big)
            or grew["verify_checked"] != len(big)
            or grew["verify_failures"] or grew["solve_errors"]
            or grew["fallbacks"] or not all(r.ok for r in res)):
        fail(f"serve: the oversize requests were not all admitted, solved "
             f"and verified ({grew}, {[r.error for r in res if not r.ok]})")
    return dsc


def staged_config(base):
    """Phase 15's configuration: phase 5's rg run with shape descent on."""
    from repro_torch.core import distributed as D

    return D.DisReduConfig(heavy_k=base.heavy_k, mode=base.mode,
                           schedule="edges-only", backend="cuda",
                           descent=True)


def staged_solve(base, g, pg, label: str, **kw):
    """One ``solve_staged`` rg run on phase 5's partition, launch counts
    reset just before and read just after; returns (members, stats,
    seconds, segment_fused launches)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import solvers as S

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    members, st = S.solve_staged(g, base.p, "rg", staged_config(base),
                                 pg=pg, device="cuda", **kw)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = launch_counts()
    launches = counts.pop("segment_fused")
    path = " -> ".join(f"{e['cell']}(L={e['L']},E={e['E']})"
                       for e in st["path"])
    phase(label, f"rg/edges-only/cuda staged: descents={st['descents']} "
                 f"path={path} seconds={dt:.3f} "
                 f"(t_total={st['t_total']:.3f} "
                 f"t_descend={st['t_descend']:.3f}) "
                 f"kernel_ratio={st['kernel_ratio']:.4f} "
                 f"kernel_launches={launches} "
                 f"off_path_kernel_launches={sum(counts.values())}")
    if launches <= 0:
        fail(f"{label}: the staged solve never launched segment_fused")
    if any(counts.values()):
        fail(f"{label}: a kernel off the MWIS path launched: {counts}")
    if not g.is_independent_set(members):
        fail(f"{label}: the member set is not independent")
    return members, st, dt, launches


def descent_phase(base, g, pg, rg_members, rg_seconds: float) -> dict:
    """Phase 15: the staged rg solve with shape descent on phase 5's
    partition, bit for bit against phase 5's rg members; each stage's
    time."""
    import numpy as np

    from repro_torch.core import solvers as S

    members, st, dt, launches = staged_solve(base, g, pg, "descent",
                                             trajectory=True)
    for s in st["stages"]:
        check = {k: s[k] for k in ("check_us", "compact_us", "pack_us",
                                   "plan_slots") if k in s}
        phase("descent", f"stage {s['phase']} on {s['shape']} (L={s['L']}) "
                         f"rounds={s['rounds']} alive={s['alive']} "
                         f"us={s['us']} need={s.get('need')} {check}")
    phase("descent", f"staged total {dt:.3f}s against phase 5's rg "
                     f"{rg_seconds:.3f}s (both with the union build)")
    if not np.array_equal(members, rg_members):
        fail("descent: the staged solve's members != phase 5's rg members")
    phase("descent", "members == phase 5's rg run, bit for bit")
    if st["descents"] == 0:
        ladder = ", ".join(f"{c.name}(L={c.L},E={c.E})"
                           for c in S.default_ladder())
        phase("descent", f"finding: no descent at this size; each stage's "
                         f"need above against the ladder: {ladder}")
    return dict(members=members, stats=st, launches=launches)


def resume_phase(base, g, pg, staged: dict, reps: int) -> dict:
    """Phase 16: kill the staged solve after its first descent, resume it
    from its checkpoint (bit for bit against phase 15), then the kernel on
    the last rung's plan; returns the kernel's record."""
    import shutil

    import numpy as np

    from repro_torch.core import distributed as D
    from repro_torch.core import solvers as S
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import InjectedFault

    root = ROOT / "build" / "resume_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        ck = CheckpointManager(str(root), keep=16)

        def kill(descents, cell):
            raise InjectedFault(f"killed after descent {descents} to {cell}")

        t0 = time.time()
        try:
            staged_solve(base, g, pg, "resume", ckpt=ck, on_descent=kill)
        except InjectedFault as e:
            phase("resume", f"{e} after {time.time() - t0:.3f}s")
        else:
            fail("resume: the staged solve took no descent to kill after")
        ck.wait()
        step = root / f"step_{ck.latest_step():09d}"
        size = sum(f.stat().st_size for f in step.iterdir())
        phase("resume", f"checkpoint step {ck.latest_step()}: {size} bytes "
                        f"in {len(list(step.iterdir()))} files")
        members, st, dt, _ = staged_solve(base, g, pg, "resume", ckpt=ck,
                                          resume=True)
        phase("resume", f"resumed solve {dt:.3f}s (union build and "
                        f"compaction replay included)")
        if (not np.array_equal(members, staged["members"])
                or st["path"] != staged["stats"]["path"]):
            fail("resume: the resumed solve != phase 15's")
        phase("resume", "members and path == phase 15's, bit for bit")
        ck.wait()
        cfg = staged_config(base)
        prob = D.build_union_problem(pg, cfg.backend, cfg.r_blk, "cuda")
        _, _, last, state, extra = S.restore_staged(ck, pg, prob, cfg,
                                                    device="cuda")
        del prob
        cell = extra["path"][-1]["cell"]
        real = int((last.aux.gid[last.aux.row.long()] >= 0).sum())
        phase("resume", f"last rung {cell}: V={last.V} real_edges={real}")
        return fused_at(f"descent-kernel {cell}", last,
                        fused_args(last, state, "edges-only"), reps)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def union_snapshot(res: dict, p: int) -> dict:
    """A union run's result in the per-PE layout (numpy): status and w
    [p, V], the offset, rounds, members and weight."""
    st = res["state"]
    return dict(status=st.status.cpu().numpy().reshape(p, -1),
                w=st.w.cpu().numpy().reshape(p, -1), offset=int(st.offset),
                rounds=res["rounds"], members=res["members"],
                weight=res.get("weight"))


#: Outputs of a dist run that are measurements, not results.
DIST_TIMES = ("seconds", "load_seconds", "launches")


def same_outputs(label: str, got: dict, want: dict, what: str) -> None:
    """Two dist runs of one instance agree rank for rank in every output
    (rounds and fold log included), bit for bit."""
    import numpy as np

    bad = [k for k in want if k not in DIST_TIMES
           and not np.array_equal(got[k], want[k])]
    if bad:
        fail(f"dist {label}: {bad} differ from {what}")


def against_union(g, out: dict, snap: dict) -> str:
    """How a per-PE run compares with the union run of its instance.  The
    per-PE sweeps are rank-local, as the reference's shard_map's are, so
    its rounds and, where a PE's heavy vertex sweeps run before the union's
    global flag lets them, its reduced graph may differ from the union's
    (the CPU tests hold the per-PE path to the reference's shard_map).
    ``out["members"]``, where the run has them, is the global mask."""
    import numpy as np

    offset = int(np.int32(out["offset"].astype(np.int64).sum()))
    line = (f"rounds {int(out['rounds'][0])} (union {snap['rounds']}), "
            f"offset {offset} (union {snap['offset']}), statuses differing "
            f"{int((out['status'] != snap['status']).sum())} of "
            f"{out['status'].size}")
    if "members" in out:
        same = np.array_equal(out["members"], snap["members"])
        line += (f", weight {g.set_weight(out['members'])} (union "
                 f"{snap['weight']}), members {'==' if same else '!='} the "
                 f"union's")
    return line


def dist_launches(label: str, out: dict) -> int:
    """Each rank's kernel launches in one dist run: segment_fused > 0, the
    three off-path kernels 0; returns segment_fused's sum over ranks."""
    counts = {k: [int(x) for x in v] for k, v in out["launches"].items()}
    fused = counts.pop("segment_fused")
    if min(fused) <= 0:
        fail(f"dist {label}: a rank never launched segment_fused: {fused}")
    if any(any(v) for v in counts.values()):
        fail(f"dist {label}: a kernel off the MWIS path launched: {counts}")
    return sum(fused)


def dist_phase(base, g, pg, red_snap: dict, rg_snap: dict, opts) -> dict:
    """Phase 17: the per-PE path (one spawned rank a PE) on the card; see
    the module docstring.  Returns the kernel's record on rank 0's plan."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core import rules as R
    from repro_torch.launch import mesh, mwis_run

    t_phase = time.time()
    torch.cuda.empty_cache()
    p = pg.p

    def cfg(**over):
        return mwis_run.config(argparse.Namespace(**{**vars(base), **over}))

    def at(n, label, **over):
        args = argparse.Namespace(**{**vars(base), "n": n})
        g_n, pg_n = mwis_run.prepare(args)
        return g_n, pg_n, union_snapshot(drive(args, g_n, pg_n, label, True,
                                               **over), p)

    g4, pg4, rnp_snap = at(opts.dist_rnp_n, "dist-rnp-union", algo="rnp",
                           schedule="edges-only")
    g5, pg5, loc_snap = at(DIST_LOCAL_N, "dist-local-union", algo="reduce",
                           schedule="cheap-fused")
    graphs, parts = (g, g4, g5), (pg, pg4, pg5)
    reduce_a2a = cfg(schedule="cheap-fused", exchange="a2a")
    reduce_ag = cfg(schedule="cheap-fused", exchange="allgather")
    edges = cfg(schedule="edges-only", exchange="allgather")
    # the first run of a spawn also pays each rank's first-use costs, so
    # compare the two exchanges' seconds across runs in both orders
    jobs = [("reduce a2a", mesh.PEJob("reduce", reduce_a2a), red_snap),
            ("reduce allgather", mesh.PEJob("reduce", reduce_ag), red_snap),
            ("rg allgather", mesh.PEJob("rg", edges), rg_snap),
            ("rnp allgather (cut)", mesh.PEJob("rnp", edges, part=1),
             rnp_snap),
            (f"reduce a2a n={DIST_LOCAL_N}",
             mesh.PEJob("reduce", reduce_a2a, part=2), loc_snap),
            (f"rg allgather n={DIST_LOCAL_N}",
             mesh.PEJob("rg", edges, part=2), None)]
    phase("dist", f"world {p}, gloo, every rank on cuda:0 (one card: NCCL "
                  f"refuses two ranks on one device, so NCCL at world > 1 "
                  f"is not run here); {len(jobs)} runs on one spawn")
    outs, stats = mesh.run_shard_map(list(parts), [j for _, j, _ in jobs],
                                     backend="gloo", device="cuda",
                                     directory=str(ROOT / "build"))
    phase("dist", f"hand-off {stats['handoff_seconds']:.3f}s (pack the "
                  f"stacked plans, write one .npz a PE) spawn "
                  f"{stats['spawn_seconds']:.3f}s (until the last rank "
                  f"joined the group) call {stats['seconds']:.3f}s")
    launches = 0
    for (label, job, snap), out in zip(jobs, outs):
        board = parts[job.part]
        per_round = p * (board.B if job.cfg.exchange == "allgather"
                         else board.S) * 5
        launches += dist_launches(label, out)
        if not (out["rounds"] == out["rounds"][0]).all():
            fail(f"dist {label}: the ranks ran different round counts")
        res = dict(out)
        if "members" in out:
            res["members"] = D.members_global_per_pe(board, out["members"])
            if not graphs[job.part].is_independent_set(res["members"]):
                fail(f"dist {label}: the members are not independent")
        line = "" if snap is None else "; " + against_union(
            graphs[job.part], res, snap)
        phase("dist", f"{label}: {job.algo}/{job.cfg.schedule}/"
                      f"{job.cfg.backend} rounds={int(out['rounds'][0])} "
                      f"seconds={np.round(out['seconds'], 3).tolist()} "
                      f"(file load {float(out['load_seconds'].max()):.3f}) "
                      f"board bytes a rank receives a round={per_round} "
                      f"(int32 w + int8 status; B={board.B} S={board.S}) "
                      f"segment_fused launches="
                      f"{out['launches']['segment_fused'].tolist()}{line}")
    same_outputs("reduce", outs[1], outs[0], "the a2a exchange's run")
    phase("dist", f"n={base.n}: reduce allgather == reduce a2a in every "
                  f"output, rounds and fold log included, bit for bit")

    # the runs of the smaller instances, held against the same four ranks
    # on the CPU (plain version) rank for rank: at these sizes the per-PE
    # rounds differ from the union's
    cpu_jobs = [(label, job._replace(part=job.part - 1))
                for label, job, _ in jobs[3:]]
    cpu, cst = mesh.run_shard_map([pg4, pg5], [j for _, j in cpu_jobs],
                                  backend="gloo", device="cpu",
                                  directory=str(ROOT / "build"))
    for (label, _), got, want in zip(cpu_jobs, outs[3:], cpu):
        same_outputs(label, got, want, "the same ranks on the CPU")
    phase("dist", f"{', '.join(l for l, _ in cpu_jobs)}: every output and "
                  f"the rounds == the same four ranks on the CPU, bit for "
                  f"bit (spawn {cst['spawn_seconds']:.3f}s, runs "
                  f"{[round(float(o['seconds'].max()), 3) for o in cpu]}s)")

    tiny = argparse.Namespace(**{**vars(base), "n": DIST_NCCL_N, "p": 1})
    g1, pg1 = mwis_run.prepare(tiny)
    one = drive(tiny, g1, pg1, "dist-nccl-union", True, algo="rg",
                schedule="edges-only")
    (out,), st = mesh.run_shard_map([pg1], [mesh.PEJob("rg", edges)],
                                    backend="nccl", device="cuda",
                                    directory=str(ROOT / "build"))
    launches += dist_launches("nccl", out)
    if not np.array_equal(D.members_global_per_pe(pg1, out["members"]),
                          one["members"]):
        fail("dist nccl: members differ from the union rg run at p = 1")
    phase("dist", f"world 1, NCCL, rg at n={DIST_NCCL_N}, p = 1: members == "
                  f"the union run (one PE: its own flag is the union's); "
                  f"spawn {st['spawn_seconds']:.3f}s run "
                  f"{float(out['seconds'][0]):.3f}s (NCCL at world size > 1 "
                  f"needs one card a rank: not held here)")

    # the kernel on rank 0's per-PE plan (its row of the stacked arrays the
    # hand-off packed) with the first sweep's payload columns
    arrs = D.shard_map_arrays(pg, reduce_a2a)
    aux, _, plan, t = D._unpack_per_pe({k: v[0] for k, v in arrs.items()},
                                       "cuda")
    del arrs
    rank0 = argparse.Namespace(plan=plan, aux=aux)
    state = R.init_state(t["w0"], t["is_local"], t["is_ghost"])
    rec = fused_at("dist-kernel rank 0", rank0,
                   fused_args(rank0, state, reduce_a2a.schedule), opts.reps)
    rec["launches"] = launches
    phase("dist", f"phase seconds={time.time() - t_phase:.1f} (four ranks "
                  f"share one card and the host: no multi-GPU time)")
    return rec


def serve_chunk(svc, reqs, cell_name: str):
    """One cell's stacked chunk as the service stacks it: its first 64
    requests of the cell (its cached problems, its E_BLK high-water mark)
    on the service's device; returns (problem, first-sweep kernel
    arguments)."""
    from repro_torch.core import rules as R
    from repro_torch.core import serve as SV

    cell = next(c for c in svc.cells if c.name == cell_name)
    idxs = [i for i, g in enumerate(reqs)
            if SV.bucket_for(g.n, g.num_directed_edges, svc.cells) is cell]
    topos, _ = svc._pack_requests(cell, idxs[:64], reqs, [None] * len(reqs),
                                  svc.cfg.backend)
    prob = svc._stage_chunk(cell, topos, svc.cfg.backend,
                            dict(pack_ms=0.0, transfer_ms=0.0)).prob
    state = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    return prob, fused_args(prob, state, cell.schedule)


def batched_kernel_at(svc, reqs, cell_name: str, reps: int) -> dict:
    """The batched kernel on a real stacked chunk of one cell (the payload
    columns of the first sweep): exact against the plain version, timed
    beside its bounds and scatter_reduce over the flat union rows."""
    prob, kw = serve_chunk(svc, reqs, cell_name)
    real = int((prob.aux.gid[prob.aux.row.long()] >= 0).sum())
    label = f"serve-kernel {cell_name} x {prob.plan.edge_perm.shape[0]}"
    phase(label, f"V={prob.V} real_edges={real}")
    return fused_at(label, prob, kw, reps)


def fused_row(name: str, rec: dict) -> dict:
    """A kernels-line row of ``segment_fused`` at one more plan: the
    batched form (its batch grid axis) at serve_m x 64, or the staged
    solve's last rung."""
    from repro_torch.kernels.segment_coo import kernel as K

    return dict(
        name=name, route="cuda",
        source=str(K.LIBS["segment_fused"][1][0].relative_to(ROOT)),
        replaces=REPLACES["segment_fused"],
        **{key: rec[key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", *FUSED_EXTRA)},
    )


def serve_phase(opts) -> dict:
    """Phase 14: the serving path on the card (see the module docstring);
    returns the batched kernel's record with the serve runs' launches."""
    import numpy as np

    from repro_torch.core import sequential as seq

    t0 = time.time()
    rg = serve_run(opts, "rg cuda", True, algo="rg", backend="cuda",
                   requests=192, verify="full")
    ref = serve_run(opts, "rg torch", False, algo="rg", backend="torch",
                    requests=192)
    for i, (a, b) in enumerate(zip(rg["results"], ref["results"])):
        if a.weight != b.weight or not np.array_equal(a.members, b.members):
            fail(f"serve: cuda and torch backends disagree on request {i}")
    phase("serve", "rg cuda == torch backend: members and weight of all "
                   f"{len(rg['results'])} requests identical")
    gr = serve_run(opts, "greedy cuda", True, algo="greedy", backend="cuda",
                   requests=192, verify="full")
    for i, (g, r) in enumerate(zip(gr["requests"], gr["results"])):
        w_seq, m_seq = seq.solve_greedy(g)
        if r.weight != w_seq or not np.array_equal(r.members, m_seq):
            fail(f"serve: greedy request {i} != sequential priority greedy")
    phase("serve", f"greedy == sequential on all {len(gr['results'])} "
                   f"requests (total weight "
                   f"{sum(r.weight for r in gr['results'])})")
    rnp = serve_run(opts, "rnp cuda", True, algo="rnp", backend="cuda",
                    requests=48, verify="full")
    dsc = serve_descent(opts, rg)
    # where a warm batch's time goes: the stream's first 64 requests (about
    # 21 of each cell, three chunks) once more on rg / cuda
    svc, first = rg["service"], rg["requests"][:64]
    device_profile("serve rg/cuda, one batch of 64 (3 chunks)",
                   lambda: svc.solve_batch(first), top=8)
    for name in ("serve_xs", "serve_s"):
        batched_kernel_at(rg["service"], rg["requests"], name, opts.reps)
    kern = batched_kernel_at(rg["service"], rg["requests"], "serve_m",
                             opts.reps)
    kern["launches"] = (rg["launches"] + gr["launches"] + rnp["launches"]
                        + dsc["launches"])
    phase("serve", f"phase seconds={time.time() - t0:.1f}")
    return kern


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="RGG vertices of the main-path instance")
    ap.add_argument("--rnp-n", type=int, default=1 << 16,
                    help="RGG vertices of the reduce-and-peel run")
    ap.add_argument("--dist-rnp-n", type=int, default=1 << 12,
                    help="RGG vertices of phase 17's rnp runs")
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

    def smi(query: str, *fmt: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=" + ",".join(("csv", "noheader") + fmt)],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    print(smi("name,power.limit"), flush=True)
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["max_sm_hz"] = float(smi("clocks.max.sm", "nounits")) * 1e6
    phase("device", f"{torch.cuda.get_device_name(0)} "
                    f"count={torch.cuda.device_count()} sms={CARD['sms']} "
                    f"max_sm_clock={CARD['max_sm_hz'] / 1e6:.0f}MHz "
                    f"torch={torch.__version__} cuda={torch.version.cuda} "
                    f"python={sys.version.split()[0]}")

    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag import kernel as EK
    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.kernels.wedge_intersect import kernel as WK
    from repro_torch.launch import mwis_run

    libs = {**K.LIBS, **WK.LIBS, **EK.LIBS}
    if set(libs) != set(REPLACES):
        fail(f"kernels {sorted(libs)} != the four of REPLACES")
    t0 = time.time()
    kernels.build_many(list(libs.values()))
    phase("build", f"{', '.join(libs)} built (in parallel) "
                   f"in {time.time() - t0:.2f}s")

    err = kernel_at_test_shapes(dev)
    if err:
        fail(f"kernel != plain version at the test shapes ({err})")
    rec = ops_at_micro_shapes(dev, opts.seed)

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
    rg_members, rg_seconds = rg["members"], rg["seconds"]
    red_snap, rg_snap = union_snapshot(red, opts.p), union_snapshot(rg, opts.p)
    kfull = kernel_at_full_size(red, opts.reps)
    wfull = wedge_at_full_size(red, opts.reps)
    replay_seconds(red, "reduce/cheap-fused")
    replay_seconds(rg, "rg/edges-only")
    launches = red["launches"] + rg["launches"]
    del red, rg

    small = argparse.Namespace(**{**vars(base), "n": opts.rnp_n})
    g2, pg2 = mwis_run.prepare(small)
    rnp = drive(small, g2, pg2, "rnp-cut", True, algo="rnp",
                schedule="edges-only")
    replay_seconds(rnp, "rnp/edges-only (cut)")
    kernel_at_rnp_plan(rnp, opts.reps)
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
    profile_reduce(*reduce_problem(base, pg))
    torch.cuda.empty_cache()
    sfull = segment_sum_at_size(dev, opts.seed, opts.reps)
    efull = embedding_bag_at_size(dev, opts.seed, opts.reps)
    sk = serve_phase(opts)
    staged = descent_phase(base, g, pg, rg_members, rg_seconds)
    dk = resume_phase(base, g, pg, staged, opts.reps)
    dk["launches"] = staged["launches"]
    xk = dist_phase(base, g, pg, red_snap, rg_snap, opts)

    kfull.update(launches=launches,
                 max_abs_err=max(err, kfull["max_abs_err"]))
    for name, full in (("segment_sum", sfull), ("wedge_intersect", wfull),
                       ("embedding_bag", efull)):
        full["launches"] += rec[name]["launches"]
        full["max_abs_err"] = max(full["max_abs_err"],
                                  rec[name]["max_abs_err"])
    found = dict(segment_fused=kfull, segment_sum=sfull,
                 wedge_intersect=wfull, embedding_bag=efull)
    rows = [dict(
        name=name, route="cuda",
        source=str(sources[0].relative_to(ROOT)), replaces=REPLACES[name],
        **{key: found[name][key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms",
            *(FUSED_EXTRA if name == "segment_fused" else ()))},
    ) for name, (_, sources) in libs.items()]
    rows.append(fused_row("segment_fused_batched", sk))
    rows.append(fused_row("segment_fused_last_rung", dk))
    rows.append(fused_row("segment_fused_dist", xk))
    phase("done", f"total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
