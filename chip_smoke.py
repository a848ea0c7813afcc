#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                    # the full-size run
    python3 chip_smoke.py --n 65536          # a smaller, quicker instance

Phases, in order (any failure exits non-zero; no phase catches and
continues):

  1. device  — the card as ``nvidia-smi`` names it, with its power limit
               and its maximum SM clock (which sets the operation bounds);
  2. build   — compile the four CUDA kernel libraries from the sources in
               this checkout, one ``nvcc`` each, all started together
               (``embedding_bag.cu`` holds the forward and the backward);
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
  9. rnp     — rnp/edges-only on ``cuda`` at ``--rnp-n`` (default 2^15:
               its host-driven peel loop does not fit the time limit at
               full size), then the kernel on its plan, timed as in phase
               6;
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
               bfloat16; then the backward kernel (the table's gradient)
               at the same size in float32, K = 1 and 4 on uniform ids and
               K = 1 on Zipf ids (a 1.05, from the seed), checked on the
               rows it touches, timed adding into a buffer zeroed outside
               the timed window, beside the zero fill of the dense [V, D]
               gradient, its plain version and ``index_add_``;
 14. serve   — ``repro_torch.launch.serve --arch mwis`` on the card: the
               reference's stream of 192 requests over the three serve
               cells (4 per topology, up to serve_m: L 1,024, E 16,384),
               batches of 64, every run with the CLI's defaults (the chunk
               pipeline on, every visible card): ``rg`` on ``cuda``
               (verify full) and on ``torch`` (must agree per request bit
               for bit), then ``rg`` on ``cuda`` with ``--no-pipeline``
               (equal request by request; every chunk of the pipelined
               run pipelined, none of this one's; both runs' rates,
               latencies, stage medians and overlap ratios, and each
               service's device busy share of a warm batch of 64), with
               ``--devices 1`` (equal to the default run), with
               ``--devices`` one past the visible count (exits 2 naming
               the visible count), and with two shards on the one card
               on the stream's first ``SERVE_CUT`` (64) requests (the
               serve mesh's ``visible_devices`` seam: equal to
               ``--devices 1``; no speed is read from it), ``greedy`` on
               ``cuda`` (each result the sequential priority greedy's),
               ``rnp`` on ``cuda`` on 48 requests (its host peel loop),
               ``rg`` on ``cuda`` with ``--descent auto`` on the first
               ``SERVE_CUT`` requests (its serve_m requests one at a time
               through the staged solver; each result must equal the
               ``--descent off`` run's), then 4
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
               independent; every rank ran one round count.  The same
               spawn runs the dry-run's sweep-round probe (one sweep, one
               heavy-vertex pass, one exchange; rg's config) on phase 5's
               arrays, counted on each rank: its (w, status, offset) equal
               the union path's first sweep-round.  Then one
               NCCL rank (p = 1, rg) equal to the union run; every rank
               launched ``segment_fused`` and no other kernel; then the
               kernel on rank 0's plan (its row of ``shard_map_arrays``)
               with the first sweep's columns, timed as in phase 6.  Four
               processes share one card and the host, so its seconds are
               no multi-GPU time;
 18. models  — the reference's other serving archs on the card.  First
               the CLI: ``repro_torch.launch.serve --arch dlrm-mlperf
               --requests 16`` (26 x 16 ``embedding_bag`` launches) and
               ``--arch gemma3-1b --tokens 16`` (no kernel), the SMOKE
               configs.  Then DLRM at the MLPerf widths with every table
               capped at 10,000,000 rows (a cut of scale: 54,068,224 rows
               x 128, 27.7 GB, weights from a seeded generator on the
               card): ``serve_p99`` (B 512, 32 requests), ``serve_bulk``
               (B 262,144, 3 batches) and ``retrieval_cand`` (1 query x
               1,000,000 candidates), once through the kernel (26 launches
               a forward, 1 a retrieval) and once through its plain
               version on the same card, every output bit for bit equal,
               one ``serve_bulk`` batch under torch.profiler.  Then
               gemma3-1b at full width and depth (bfloat16) decoding 32
               steps for a batch of 16 from ``cache_len`` 32,736 of a
               32,768-position cache filled from a seeded generator (the
               stand-in for a prefilled context; ``decode_32k``'s batch of
               128 is cut to 16), logits finite, the last 4 steps under
               torch.profiler; then the same widths at 2 layers in float32
               (batch 2, a 1,024-position cache) on the card and on the
               CPU from one seed: logits within 1e-4 of the largest,
               greedy tokens equal;
 19. train   — LM training (no kernel of the port on this path; none may
               launch).  First the CLI on the SMOKE configs:
               ``repro_torch.launch.train --arch gemma3-1b --steps 21
               --save-every 10``, then the same ``--ckpt`` with ``--steps
               31`` (it must restore step 20 and run steps 21-30 only),
               then ``--arch qwen3-moe-235b-a22b --steps 11``, every
               printed loss finite.  Then gemma3-1b at full width and
               depth (bfloat16, ~1.00 B parameters) at ``train_4k``'s seq
               4,096 with the batch cut from 256 to 4: 4 AdamW steps (lr
               3e-4) on one ``lm_batch``, each loss finite
               and the last below the first, ms a step (p50 of steps 2-4),
               tokens a
               second, peak memory, and one more step under
               torch.profiler (busy share, device time by op, device ops
               a step).  Then the same widths at 2 layers in float32 (no
               TF32), B 1, T 640 (the 512-token window masks):
               ``loss_fn`` within 1e-5 relative and every weight's
               gradient within 1e-4 of its largest on the card and on
               the CPU from one seed.  Then qwen3-moe-235b-a22b at full
               width cut from 94 to 2 layers (~5.6 B parameters,
               bfloat16), B 1 at seq 4,096: ``prefill_step``'s logits
               finite, the share of expert assignments kept at capacity
               (cap 320), and one Adafactor train step (AdamW's float32
               moments would not fit beside the weights and grads),
               finite, its ms and peak memory.
 20. train-archs — DLRM and GNN training.  (a) ``dlrm_mlperf.smoke`` and
               each GNN config's ``smoke`` on the card: ``embedding_bag``
               forward and backward on DLRM's, ``segment_sum`` on the
               GNNs', ``segment_fused`` and ``wedge_intersect`` never.
               (b) dlrm-mlperf at the MLPerf widths, every table capped at
               2,000,000 rows (13,114,880 rows, 6.7 GB a float32 copy), at
               ``train_batch``'s B 65,536: 6 AdamW steps on one
               ``dlrm_batch``, losses finite and falling, ms a step (p50
               of steps 2-5), samples a second, peak memory, one more step
               profiled; then the backward kernel timed on the batch's ids
               into the largest capped table and into each of the 8 tables
               of 155 rows or fewer (hot rows).  (c) graphsage-reddit's CONFIG at ``minibatch_lg``:
               ``sample_fanout`` of 1,024 seeds at fanouts (15, 10) on a
               generated graph of degree >= 16 everywhere (169,984 nodes,
               168,960 edges; Reddit itself is not in the repository), 6
               AdamW steps as in (b).  (d) gatedgcn's CONFIG at
               ``full_graph_sm`` and (e) dimenet's and equiformer-v2's at
               ``molecule`` (128 graphs of 30 atoms, triplets at the
               reference's budget), 3 steps each; each GNN run prints its
               plans' host time a forward; ``ogb_products`` does not fit
               one card (a gather of [123.7 M, 100] float32 alone is 49
               GB).  Then ``segment_sum`` timed on graphsage's own plan.
               (f) float32 card against CPU from one seed: DLRM's SMOKE,
               each GNN's SMOKE on the smoke runner's graph, and
               graphsage's CONFIG on a 64-seed sample: the loss within
               1e-5 relative, every weight's gradient within 1e-4 of its
               largest.
 21. dryrun  — the dry-run (``repro_torch.launch.dryrun``, its work counter
               ``analysis/count.py``).  gemma3-1b's SMOKE at ``train_4k``
               (seq 64, batch 2), dlrm-mlperf's SMOKE at ``train_batch``
               and graphsage's SMOKE at ``full_graph_sm``, each counted on
               the card and on the CPU from the same inputs: FLOPs, bytes
               and each kernel's units, operations and bytes equal, and on
               the card each kernel's units equal to its launches.  Then
               ``gemma3-1b × decode_32k`` and ``dlrm-mlperf × serve_p99``
               at full size as the CLI counts them by default (on meta;
               a record counted elsewhere, marked ``superseded_by`` or
               launching a kernel fails): flops, transcendentals and
               flops by op class, bytes, t_bound, bottleneck, host_s and
               roofline fraction on the ``card`` mesh; phase 17's
               sweep-round probe (run on its four gloo ranks: (w, status,
               offset) equal to the union path's first sweep-round) as an
               MWIS record; the abstract count (meta tensors) held to
               the card, every term equal and each kernel's units its
               launches, at the three SMOKE cells and ``DRYRUN_META``'s
               full-width probe points (gemma3-1b and qwen3-moe
               ``decode_32k`` at L 2, graphsage ``minibatch_lg``, DLRM
               ``train_batch`` at 1 M rows a table; the card takes the
               meta run's host-drawn index arrays), with each point's meta
               temp bytes against the card's peak (reported, not gated);
               then ``DRYRUN_META_ONLY``, two cells that fit no card
               (gatedgcn ``ogb_products``, qwen3-moe ``train_4k``, full
               width, 2 layers), on meta alone, the training cell also
               with each layer's weights indexed from the stack: its
               bytes and ``select_backward`` bytes both ways (no more
               FLOPs, fewer bytes and no ``select_backward`` with the
               layers cut by ``unbind``, or it fails); the
               ``DRYRUN_SHARDED`` cells (qwen3-moe ``train_4k`` at L 2 on
               ``single``, DLRM ``train_batch`` on ``multi``) as sharded
               programs on the fake production meshes, each beside its
               even split (argument bytes, collectives by kind,
               t_collective_s, bottleneck, host_s; a failed sharded count
               fails);
               ``compress_int8_ef`` / ``topk_ef`` on CUDA tensors bit for
               bit with the CPU; ``hierarchical_psum`` on 4 gloo ranks (2
               pods x 2 data) on cuda:0 against a flat ``all_reduce``.
               ``segment_fused``, ``segment_sum``, ``embedding_bag`` and
               its backward must each have launched.

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

#: Phase 18: dlrm-mlperf at its widths with each table capped at this many
#: rows (so the 26 tables fit one card), and its RECSYS_SHAPES cells
#: (src/repro/configs/base.py:45-50).
DLRM_ROW_CAP = 10_000_000
DLRM_CELLS = dict(serve_p99=(512, 32), serve_bulk=(262_144, 3),
                  retrieval_cand=1_000_000)
#: Phase 18: gemma3-1b's decode at a 32k context (``decode_32k``, batch cut
#: from 128 to 16) and the 2-layer float32 card-against-CPU check.
LM_DECODE = dict(batch=16, seq=32_768, steps=32, profiled=4)
LM_CHECK = dict(layers=2, batch=2, seq=1024, start=1016, steps=4)
#: Phase 19: gemma3-1b training at ``train_4k``'s seq with the batch cut
#: from 256 to 4; the 2-layer float32 card-against-CPU check (T 640 so the
#: 512-token window masks); qwen3-moe at full width cut to 2 layers.
LM_TRAIN = dict(batch=4, seq=4096, steps=4, lr=3e-4)
TRAIN_CHECK = dict(layers=2, batch=1, seq=640)
MOE_TRAIN = dict(layers=2, batch=1, seq=4096)

#: Phase 20: dlrm-mlperf training at the MLPerf widths with each table
#: capped at ``row_cap`` rows (13,114,880 padded rows, 6.7 GB a float32
#: copy) at RECSYS_SHAPES' ``train_batch`` (src/repro/configs/base.py:46).
DLRM_TRAIN = dict(row_cap=2_000_000, batch=65_536, steps=6, lr=3e-4)
#: Phase 20: the GNN shapes it trains at (src/repro/configs/base.py:33-44;
#: ``ogb_products`` does not fit one card) and their steps; graphsage's
#: sampled graph is ``fanout_graph``'s, at 1,024 seeds (minibatch_lg) and
#: at ``check_seeds`` for the card-against-CPU check.
GNN_SHAPES = dict(
    full_graph_sm=dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    molecule=dict(n_nodes=3840, n_edges=8192, n_graphs=128),
)
GNN_TRAIN = dict(steps=6, short_steps=3, lr=3e-4, check_seeds=64)

#: Phase 21: the dry-run's cells counted on the card and on the CPU in one
#: process (SMOKE widths, inputs made on the CPU and copied to the card;
#: the LM's seq and batch cut so its CPU run takes seconds) and two
#: full-size cells as ``launch.dryrun`` counts them by default (on meta).
DRYRUN_SMOKE = (("gemma3-1b", "train_4k", dict(seq=64, batch=2)),
                ("dlrm-mlperf", "train_batch", {}),
                ("graphsage-reddit", "full_graph_sm", {}))
DRYRUN_FULL = (("gemma3-1b", "decode_32k"), ("dlrm-mlperf", "serve_p99"))
#: Phase 21: the ``DRYRUN_FULL`` cell also counted by the card probe route
#: (``launch.dryrun --probes``, ``run_cell(abstract=False)``) at full width:
#: probes on the card, the plan's out-of-memory fallback, the multilinear
#: extrapolation, each kernel's counted units against its launches.
DRYRUN_CARD_ROUTE = ("dlrm-mlperf", "serve_p99")
#: Phase 21: one probe point of a full-width cell per family that the card
#: counts, counted on meta (the abstract count) and on the card from the
#: same host-drawn index arrays: every term must be equal.
DRYRUN_META = (("gemma3-1b", "decode_32k", dict(n_layers=2)),
               ("qwen3-moe-235b-a22b", "decode_32k", dict(n_layers=2)),
               ("graphsage-reddit", "minibatch_lg", {}),
               ("dlrm-mlperf", "train_batch", dict(row_cap=1_000_000)))
#: Phase 21: cells that fit no card, counted on meta alone at full width
#: and 2 layers; the training cell also with each layer's weights indexed
#: from the stack (``STACKED_CELL``), the slicing ``common.layer_slices``
#: replaced, to show the ``select_backward`` bytes it cost.
DRYRUN_META_ONLY = (("gatedgcn", "ogb_products", dict(n_layers=2)),
                    ("qwen3-moe-235b-a22b", "train_4k", dict(n_layers=2)))
STACKED_CELL = ("qwen3-moe-235b-a22b", "train_4k")
#: Phase 21: cells counted as a sharded program on a production mesh
#: (``launch.dryrun``'s ``single`` / ``multi`` records: one rank of a
#: fake process group on meta DTensors), each beside its even split.
DRYRUN_SHARDED = (("qwen3-moe-235b-a22b", "train_4k", dict(n_layers=2),
                   "single"),
                  ("dlrm-mlperf", "train_batch", {}, "multi"))

#: Phase 14's two-shard and ``--descent auto`` runs serve the first this
#: many requests of the 192-request stream (its other runs, the whole
#: stream); each is held request by request to a run of the whole stream.
SERVE_CUT = 64

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
    # the port's own: the reference differentiates this jnp.take
    "embedding_bag_backward": "src/repro/models/dlrm.py:84",
}
#: Kernels built into another kernel's library (by library name).
SHARED_LIBRARY = {"embedding_bag_backward": "embedding_bag"}
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
    the HBM rate or the operations at their class's rate.  A kernel's bytes
    and operations are its formula's (``kernels/<name>/cost.py``), which
    the dry-run's work counter records a call as."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_per_s = (LANES_PER_SM_CLOCK[op_class] * CARD["sms"]
                 * CARD["max_sm_hz"])
    ops_ms = n_ops / ops_per_s * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by


def timings(label: str, kernel, plain, library, reps: int, work) -> dict:
    """CUDA-event times of the kernel, its plain version and (where there
    is one) the single PyTorch call computing the same function, beside the
    bound of ``work`` (``kernels.Work``: the kernel's cost formula on the
    call's arguments)."""
    n_bytes, n_ops, op_class = work.bytes, work.ops, work.op_class
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
    from repro_torch.kernels.wedge_intersect.cost import wedge_intersect_work
    from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
    from repro_torch.kernels.wedge_intersect.ref import (
        common_neighbor_stats_ref,
    )

    prob, aux = res["prob"], res["prob"].aux
    init = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    n_edges = aux.row.shape[0]
    n_vertices, d = aux.window.shape
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
        t = timings(tag, lambda: WK.wedge_intersect(*args),
                    lambda: common_neighbor_stats_ref(*args), None, reps,
                    wedge_intersect_work(*args))
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
    from repro_torch.kernels.segment_coo.cost import (
        segment_fused_live_bytes, segment_fused_work,
    )
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
    work = segment_fused_work(plan.edge_perm, plan.lrow, n_rows, **kw)
    plan_bytes, n_ops = work.bytes, work.ops
    live_bytes = segment_fused_live_bytes(plan.edge_perm, plan.lrow, n_rows,
                                          **kw)

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


def device_profile(label: str, fn, top: int = 15,
                   cpu_ops: bool = True) -> dict:
    """Run ``fn`` once under torch.profiler: device time by kernel and
    (``cpu_ops``) by launching op, and the device's busy share of the
    call's wall time.  Returns the aten ops by name (none without
    ``cpu_ops``: a call of ~10^5 launches has ~10^6 host events, which
    the profiler takes minutes to sum)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu_ops
    with profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    t_avg = time.time()
    avg = prof.key_averages()
    rows = [e for e in avg
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    phase("profile", f"{label} wall={wall:.3f}s "
                     f"device_busy={busy_us / 1e6:.3f}s "
                     f"busy_share={busy_us / 1e6 / wall:.4f} "
                     f"device_ops={sum(e.count for e in rows)}")
    if not rows:
        phase("profile", "the profiler saw no device time: not measured")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:top]:
        phase("profile", f"{e.device_time_total / 1e3:10.3f} ms "
                         f"x{e.count:<6d} {e.key[:90]}")
    # the same device time by the torch op that launched it (an op's time
    # includes the ops it calls, so nested rows overlap)
    ops = [e for e in avg
           if e.key.startswith("aten::")
           and getattr(e, "device_time_total", 0) > 0]
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:top]:
        phase("profile", f"op {e.device_time_total / 1e3:10.3f} ms "
                         f"x{e.count:<6d} {e.key}")
    phase("profile", f"trace summed in {time.time() - t_avg:.1f}s")
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
    from repro_torch.kernels.segment_coo.cost import segment_sum_work
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
            t = timings(tag, lambda: K.segment_sum(data, perm, lrow, n_rows,
                                                   r_blk=r_blk),
                        lambda: segment_sum_plain(data, perm, lrow, n_rows,
                                                  r_blk=r_blk),
                        library, reps, segment_sum_work(
                            data, perm, lrow, n_rows, r_blk=r_blk))
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
    from repro_torch.kernels.embedding_bag.cost import embedding_bag_work
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
            t = timings(tag, lambda: EK.embedding_bag(table, idx, wgt),
                        lambda: embedding_bag_ref(table, idx, wgt),
                        library, reps, embedding_bag_work(table, idx, wgt))
            if (dtype == torch.float32
                    and k_bag == EMBEDDING_BAG_SIZE["bags"][0]):
                out.update(t)
        del table
        torch.cuda.empty_cache()
        if dtype == torch.float32:
            out["backward"] = embedding_bag_bwd_at_size(dev, gen, seed,
                                                        reps)
    return out


def check_embedding_bag_bwd(got, cot, idx, wgt, n_rows: int,
                            label: str) -> float:
    """Backward kernel vs its plain version (both accumulate in float32 and
    round once; the kernel's atomics and the plain ``index_add_`` add in
    any order) on the rows the lookups touch, and no other row written.
    Tolerance: float32, 1e-6 of each row's sum of |w g| (per column),
    which at one or two lookups a row is 1e-6 of the entry and covers a
    hot row's thousands of terms summed in another order; bfloat16, one
    bfloat16 ulp of the largest entry (2^-7 of it) on top.  Returns the
    max abs error."""
    import torch

    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_bwd_ref, live_rows,
    )

    rows, live = live_rows(idx, n_rows)
    uniq, inv = torch.unique(rows[live], return_inverse=True)
    want = embedding_bag_bwd_ref(cot, idx, wgt, n_rows, got.dtype)[uniq]
    terms = (cot.float().abs()[:, None, :] * wgt.abs()[..., None])[live]
    scale = torch.zeros((uniq.shape[0], cot.shape[1]), device=cot.device
                        ).index_add_(0, inv, terms)
    tol, what = 1e-6 * scale, "1e-6 sum|w g|"
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs().max()
        what += " + 2^-7 max|want|"
    diff = (got[uniq].float() - want.float()).abs()
    err = float(diff.max())
    extra = int(torch.count_nonzero(got)) - int(torch.count_nonzero(
        got[uniq]))
    phase(label, f"max_abs_err={err:.3e} (tolerance {what}) over "
                 f"{uniq.shape[0]} touched rows; nonzero entries off them: "
                 f"{extra}")
    if not bool((diff <= tol).all()) or extra:
        fail(f"{label}: embedding_bag backward kernel outside its "
             f"tolerance ({err}) or wrote {extra} entries off its rows")
    return err


def time_embedding_bag_bwd(label: str, cot, idx, wgt, n_rows: int,
                           reps: int) -> dict:
    """The backward kernel on one case: checked against its plain version,
    then timed (CUDA events) adding into a buffer zeroed once outside the
    timed window, as wrapper calls and by CUDA-graph replay (``graph_ms``:
    the card's time, where a short kernel takes less than the wrapper's
    host cost), beside the zero fill of a dense [V, D] float32 gradient
    (the reference's semantics), its plain version (which allocates and
    zeroes its own), ``index_add_`` of the weighted rows (computed before
    the timed window) into the same buffer, and the bound.  Launch counts
    here are the check's, not a path's."""
    import torch

    from repro_torch.kernels.embedding_bag import kernel as EK
    from repro_torch.kernels.embedding_bag.cost import embedding_bag_bwd_work
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_bwd_ref, live_rows,
    )

    d = cot.shape[1]
    buf = EK.embedding_bag_bwd(cot, idx, wgt, n_rows)
    err = check_embedding_bag_bwd(buf, cot, idx, wgt, n_rows, label)
    rows, live = live_rows(idx, n_rows)
    rows_l = rows[live]
    weighted = (cot.float()[:, None, :] * wgt[..., None])[live]
    touched = int(torch.unique(rows_l).shape[0])
    zero_ms = cuda_ms(lambda: buf.zero_(), max(reps // 4, 2), warmup=1)
    t = timings(label, lambda: EK.embedding_bag_bwd(cot, idx, wgt, n_rows,
                                                    out=buf),
                lambda: embedding_bag_bwd_ref(cot, idx, wgt, n_rows,
                                              torch.float32),
                lambda: buf.index_add_(0, rows_l, weighted), reps,
                embedding_bag_bwd_work(cot, idx, wgt, n_rows))
    card = graph_ms(lambda: EK.embedding_bag_bwd(cot, idx, wgt, n_rows,
                                                 out=buf), reps)
    phase(label, f"card (CUDA-graph replay) graph_ms={card:.5f} "
                 f"bound/graph={t['bound_ms'] / card:.4f}; zero fill of "
                 f"the dense [{n_rows}, {d}] float32 gradient "
                 f"zero_ms={zero_ms:.5f} (outside the kernel's window); "
                 f"touched rows {touched}; library: index_add_ of the "
                 f"weighted rows (product made before the window)")
    del buf, weighted
    torch.cuda.empty_cache()
    return dict(t, graph_ms=card, zero_ms=zero_ms, max_abs_err=err)


def zipf_ids(shape: tuple, n_rows: int, alpha: float, seed: int):
    """Int32 ids drawn from a Zipf law of exponent ``alpha`` truncated to
    ``n_rows`` ranks (numpy's ``zipf``, draws above ``n_rows`` redrawn),
    rank k on row k - 1: a few rows take most lookups, as in click logs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    out = np.empty(0, dtype=np.int64)
    while out.size < n:
        z = rng.zipf(alpha, 2 * (n - out.size))
        out = np.concatenate([out, z[z <= n_rows]])
    return (out[:n] - 1).astype(np.int32).reshape(shape)


def embedding_bag_bwd_at_size(dev, gen, seed: int, reps: int) -> dict:
    """Phase 13's backward: the table's gradient at dlrm-mlperf's largest
    table (V 39,979,771, D 128) and ``serve_bulk``'s B 262,144, K 1 and 4
    on uniform ids, then K 1 on Zipf ids (a 1.05, ``zipf_ids`` from the
    seed), float32, weights and a random cotangent from the seed (row 4b
    of the kernel table).  Returns uniform K 1's timings."""
    import torch

    V, D, B = (EMBEDDING_BAG_SIZE[k] for k in "VDB")
    out = {}
    cases = [(k, "uniform") for k in EMBEDDING_BAG_SIZE["bags"]]
    for k_bag, draw in cases + [(1, "zipf")]:
        if draw == "zipf":
            idx = torch.from_numpy(zipf_ids((B, 1), V, 1.05, seed)).to(dev)
        else:
            idx = torch.randint(0, V, (B, k_bag), generator=gen,
                                device=dev, dtype=torch.int32)
        wgt = torch.randn((B, k_bag), generator=gen, device=dev)
        cot = torch.randn((B, D), generator=gen, device=dev)
        t = time_embedding_bag_bwd(f"embedding_bag_bwd-size K={k_bag} "
                                   f"{draw} float32", cot, idx, wgt, V,
                                   reps)
        if (k_bag, draw) == cases[0]:
            out = t
        else:
            out["max_abs_err"] = max(out["max_abs_err"], t["max_abs_err"])
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
        flag = f"--{k.replace('_', '-')}"
        argv += [flag] if v is True else [flag, str(v)]
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
                   f"devices={st['devices']} pipeline={st['pipeline']} "
                   f"chunks={st['chunks']} "
                   f"pipelined_chunks={st['pipelined_chunks']} "
                   f"overlap_ratio={st['overlap_ratio']} "
                   f"cache_hits={st['cache_hits']} "
                   f"cache_misses={st['cache_misses']} "
                   f"e_blk_hwm={st['e_blk_hwm']} "
                   f"kernel_launches={out['launches']} "
                   f"seconds={out['seconds']:.2f}")
    if st["fallbacks"] or st["backend_active"] != args.backend:
        fail(f"{label}: the service left its backend ({st['events']})")
    if st["pipeline_retries"]:
        fail(f"{label}: {st['pipeline_retries']} pipelined chunk(s) "
             f"retried ({out['service'].events})")
    if st["verify_failures"] or any(not r.ok for r in out["results"]):
        fail(f"{label}: a request failed or did not verify")
    if need_launches and out["launches"] <= 0:
        fail(f"{label}: the cuda backend never launched the kernel")
    if not need_launches and out["launches"] != 0:
        fail(f"{label}: the kernel launched on a non-cuda backend")
    if any(counts.values()):
        fail(f"{label}: a kernel off the serving path launched: {counts}")
    return out


def same_requests(label: str, got: dict, want: dict) -> None:
    """Fail unless two serve runs gave every request the same members and
    weight."""
    import numpy as np

    for i, (a, b) in enumerate(zip(got["results"], want["results"])):
        if a.weight != b.weight or not np.array_equal(a.members, b.members):
            fail(f"serve: {label} disagree on request {i}")
    phase("serve", f"{label}: members and weight of all "
                   f"{len(got['results'])} requests identical")


def serve_pipeline(opts, rg: dict) -> list:
    """Phase 14's pipeline and serve-mesh runs beside the default run
    ``rg`` (rg / cuda, pipeline on, every visible card); returns them."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import mesh
    from repro_torch.launch import serve as serve_cli

    off = serve_run(opts, "rg cuda --no-pipeline", True, algo="rg",
                    backend="cuda", requests=192, verify="full",
                    no_pipeline=True)
    same_requests("rg cuda pipeline on and off", rg, off)
    s_on, s_off = rg["service"].stats, off["service"].stats
    if not (s_on["pipelined_chunks"] == s_on["chunks"] > 0
            and s_off["pipelined_chunks"] == 0 < s_off["chunks"]):
        fail(f"serve: pipelined chunks {s_on['pipelined_chunks']} of "
             f"{s_on['chunks']} (on), {s_off['pipelined_chunks']} of "
             f"{s_off['chunks']} (off)")
    for label, run in (("on", rg), ("off", off)):
        tp, st = run["throughput"], run["service"].stats
        phase("serve", f"pipeline {label}: inst_per_s="
                       f"{tp['instances_per_sec']} p50_ms={tp['p50_ms']} "
                       f"p99_ms={tp['p99_ms']} "
                       f"stage_p50_ms={st['stage_p50_ms']} "
                       f"overlap_ratio={st['overlap_ratio']} "
                       f"chunks={st['chunks']} "
                       f"pipelined={st['pipelined_chunks']}")
    for label, run in (("on", rg), ("off", off)):
        svc, first = run["service"], run["requests"][:64]
        device_profile(f"serve rg/cuda pipeline {label}, one warm batch "
                       f"of 64 (3 chunks)",
                       lambda: svc.solve_batch(first), top=8)
    one = serve_run(opts, "rg cuda --devices 1", True, algo="rg",
                    backend="cuda", requests=192, verify="full", devices=1)
    same_requests("rg cuda --devices 1 and the default run", one, rg)
    visible = torch.cuda.device_count()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            serve_cli.main(["--arch", "mwis", "--device", "cuda",
                            "--devices", str(visible + 1)])
            code = 0
        except SystemExit as e:
            code = e.code
    if code != 2 or f"the {visible} visible" not in err.getvalue():
        fail(f"serve: --devices {visible + 1} exited {code}: "
             f"{err.getvalue()!r}")
    phase("serve", f"--devices {visible + 1}: exit 2, "
                   f"{err.getvalue().strip()!r}")
    seam = mesh.visible_devices
    mesh.visible_devices = lambda kind: (torch.device("cuda", 0),) * 2
    try:
        two = serve_run(opts, "rg cuda, two shards on one card (no speed "
                        "read)", True, algo="rg", backend="cuda",
                        requests=SERVE_CUT, verify="full", devices=2)
    finally:
        mesh.visible_devices = seam
    if {r["devices"] for r in two["service"]._stage_log} != {2}:
        fail("serve: the two-shard run did not split its chunks in two")
    same_requests("rg cuda two shards on one card and --devices 1", two,
                  one)
    return [off, one, two]


def serve_descent(opts, off: dict) -> dict:
    """Phase 14's descent run: the same stream with ``--descent auto``
    (each request equal to the ``--descent off`` run ``off``), then 4
    oversize requests admitted through ``descent_xl``, verified."""
    import numpy as np

    from repro_torch.core import serve as SV
    from repro_torch.graphs.generators import gnm

    dsc = serve_run(opts, "rg cuda descent=auto", True, algo="rg",
                    backend="cuda", requests=SERVE_CUT, verify="full",
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


def union_sweep_round(prob, cfg):
    """The dry-run's sweep-round probe on the union path: one sweep of
    ``cfg.schedule``, one heavy-vertex pass, one union exchange, from the
    initial state."""
    from repro_torch.core import engine as E
    from repro_torch.core import exchange as X
    from repro_torch.core import rules as R

    st = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    st = E.sweep(st, prob.aux, schedule=cfg.schedule, backend=cfg.backend,
                 plan=prob.plan)
    if cfg.use_heavy:
        st = R.rule_heavy_vertex(st, prob.aux, cfg.heavy_k)
    st, _ = X.exchange_union(st, prob.aux, prob.halo, backend=cfg.backend,
                             plan=prob.plan)
    return st


def dist_phase(base, g, pg, red_snap: dict, rg_snap: dict, uprob,
               opts) -> dict:
    """Phase 17: the per-PE path (one spawned rank a PE) on the card; see
    the module docstring.  Returns the kernel's record on rank 0's plan,
    with the dry-run's sweep-round probe on the same ranks (its outputs
    held against ``uprob``, phase 5's union problem) under
    ``sweep_probe``."""
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
             mesh.PEJob("rg", edges, part=2), None),
            # the dry-run's MWIS probe (launch/dryrun.py): one sweep-round
            # at strong_128m's schedule and exchange on phase 5's arrays
            ("sweep-round probe", mesh.PEJob("sweep", edges), None)]
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
        if job.algo == "sweep":
            continue
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
                for label, job, _ in jobs[3:6]]
    cpu, cst = mesh.run_shard_map([pg4, pg5], [j for _, j in cpu_jobs],
                                  backend="gloo", device="cpu",
                                  directory=str(ROOT / "build"))
    for (label, _), got, want in zip(cpu_jobs, outs[3:6], cpu):
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
    rec["sweep_probe"] = sweep_probe_against_union(outs[-1], uprob, edges,
                                                   pg)
    phase("dist", f"phase seconds={time.time() - t_phase:.1f} (four ranks "
                  f"share one card and the host: no multi-GPU time)")
    return rec


def sweep_probe_against_union(out: dict, uprob, cfg, pg) -> dict:
    """The per-PE sweep-round probe's (w, status, offset) against the union
    path's first sweep-round on the same instance: equal bit for bit (one
    sweep from the initial state is the same per-PE work on both paths;
    only later rounds see the per-PE path's rank-local flags).  Returns
    the probe's count record (its ranks' summed), with the partition's
    per-PE shape and the config."""
    import numpy as np

    from repro_torch.configs import base as cbase

    rec = cbase.rank_counts(out)
    st = union_sweep_round(uprob, cfg)
    p = pg.p
    want = dict(w=st.w.cpu().numpy().reshape(p, -1),
                status=st.status.cpu().numpy().reshape(p, -1))
    offset = int(np.int32(out["offset"].astype(np.int64).sum()))
    bad = {k: int((out[k] != v).sum()) for k, v in want.items()}
    line = (f"statuses differing {bad['status']}, weights differing "
            f"{bad['w']} of {want['w'].size}; offset {offset} (union "
            f"{int(st.offset)})")
    if any(bad.values()) or offset != int(st.offset):
        fail(f"dist sweep-round probe != the union path's first "
             f"sweep-round: {line}")
    phase("dist", f"sweep-round probe ({cfg.schedule}, {cfg.exchange}, "
                  f"heavy_k {cfg.heavy_k}): w, status and offset == the union "
                  f"path's first sweep + heavy-vertex pass + exchange, bit "
                  f"for bit ({line}); counted on the ranks: flops "
                  f"{rec['flops']} bytes {rec['bytes']} collectives "
                  f"{rec['collectives']} kernels {rec['kernels']} run_s "
                  f"{rec['run_s']:.4f} (slowest rank)")
    rec["shape"] = {k: int(getattr(pg, k)) for k in "LEGBS"}
    rec["pes"] = p
    rec["cfg"] = f"{cfg.schedule}/{cfg.exchange}/{cfg.backend}"
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
    prob, = svc._stage_chunk(cell, topos, svc.cfg.backend, svc._new_rec(
        cell, svc.cfg.backend, pipelined=False)).probs
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
    same_requests("rg cuda and torch backends", rg, ref)
    more = serve_pipeline(opts, rg)
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
    for name in ("serve_xs", "serve_s"):
        batched_kernel_at(rg["service"], rg["requests"], name, opts.reps)
    kern = batched_kernel_at(rg["service"], rg["requests"], "serve_m",
                             opts.reps)
    kern["launches"] = (rg["launches"] + gr["launches"] + rnp["launches"]
                        + dsc["launches"] + sum(r["launches"] for r in more))
    phase("serve", f"phase seconds={time.time() - t0:.1f}")
    return kern


def plain_lookup(table, idx, host_idx=None):
    """DLRM's lookup through the kernel's plain version (phase 18's second
    pass, and the reference the kernel pass must equal bit for bit)."""
    import torch

    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    rows = idx.contiguous()[:, None]
    return embedding_bag_ref(table, rows, torch.ones(rows.shape,
                                                     device=rows.device))


def cli_models(dev, opts) -> int:
    """Phase 18, first part: the serving CLI's DLRM and LM archs on the card
    (SMOKE configs), launch counts reset just before and read just after
    each; returns the DLRM run's ``embedding_bag`` launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import serve as serve_cli

    runs = ((["--arch", "dlrm-mlperf", "--requests", "16"], 26 * 16),
            (["--arch", "gemma3-1b", "--tokens", "16"], 0))
    launches = 0
    for argv, want in runs:
        args = serve_cli.build_parser().parse_args(
            [*argv, "--device", dev.type, "--seed", str(opts.seed)])
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        out = (serve_cli.serve_dlrm if args.arch == "dlrm-mlperf"
               else serve_cli.serve_lm)(args)
        torch.cuda.synchronize()
        counts = launch_counts()
        phase("models", f"cli {' '.join(argv)}: launches={counts} "
                        f"seconds={time.time() - t0:.2f}")
        if counts != {**{k: 0 for k in counts}, "embedding_bag": want}:
            fail(f"models: cli {argv[1]} launched {counts}, expected "
                 f"{want} embedding_bag launches and no other kernel")
        if args.arch != "dlrm-mlperf" and not bool(
                torch.isfinite(out["logits"]).all()):
            fail("models: cli LM logits are not finite")
        launches += want
    return launches


def dlrm_pass(dev, model, cfg, batches: dict, kernel: bool) -> dict:
    """One pass of phase 18's DLRM cells: each request from its numpy batch
    (host to device copy included) to its synchronised output, host
    clock; launch counts reset before and read after every call (26 a
    forward through the kernel, 1 a retrieval; none through the plain
    lookup).  Returns the outputs, the latencies and the launches."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models import dlrm as DM

    per_call = {"serve": cfg.n_sparse, "retrieval": 1}
    label = "kernel" if kernel else "plain lookup"
    out = dict(outputs=[], ms={}, launches=0)

    def call(kind, step, b):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        y = step(model, tb, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = launch_counts()
        want = per_call[kind] if kernel else 0
        if n != {**{k: 0 for k in n}, "embedding_bag": want}:
            fail(f"models: dlrm {kind} ({label}) launched {n}, expected "
                 f"{want} embedding_bag launches")
        out["launches"] += want
        out["outputs"].append(y)
        return ms

    with torch.no_grad():
        for cell in ("serve_p99", "serve_bulk"):
            out["ms"][cell] = [call("serve", DM.serve_step, b)
                               for b in batches[cell]]
        out["ms"]["retrieval_cand"] = [call(
            "retrieval", DM.retrieval_step, batches["retrieval_cand"])]
    p99 = np.asarray(out["ms"]["serve_p99"][1:])
    phase("models", f"dlrm {label}: serve_p99 B={DLRM_CELLS['serve_p99'][0]} "
                    f"p50_ms={np.percentile(p99, 50)} "
                    f"p99_ms={np.percentile(p99, 99)} (first request "
                    f"{out['ms']['serve_p99'][0]} ms left out); serve_bulk "
                    f"B={DLRM_CELLS['serve_bulk'][0]} ms="
                    f"{out['ms']['serve_bulk']}; retrieval_cand "
                    f"{DLRM_CELLS['retrieval_cand']} candidates ms="
                    f"{out['ms']['retrieval_cand'][0]}; "
                    f"embedding_bag launches={out['launches']}")
    return out


def dlrm_at_width(dev, opts) -> int:
    """Phase 18, second part: dlrm-mlperf at its widths (tables capped at
    ``DLRM_ROW_CAP`` rows) through the kernel and through the plain lookup,
    bit for bit; returns the kernel pass's ``embedding_bag`` launches."""
    import dataclasses
    import unittest.mock

    import numpy as np
    import torch

    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data.pipeline import DLRMBatchSpec, dlrm_batch
    from repro_torch.models import common as MC
    from repro_torch.models import dlrm as DM

    cfg = dataclasses.replace(dlrm_mlperf.CONFIG, vocabs=tuple(
        min(v, DLRM_ROW_CAP) for v in DM.MLPERF_VOCABS))
    specs = DM.param_specs(cfg)
    rows = sum(s.shape[0] for s in specs["tables"].values())
    torch.cuda.synchronize()
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    model = DM.DLRM(cfg, MC.init_params(specs, gen, dev))
    torch.cuda.synchronize()
    phase("models", f"dlrm-mlperf widths (embed {cfg.embed_dim}, bot "
                    f"{cfg.bot_mlp}, top {(cfg.top_in,) + cfg.top_mlp}), "
                    f"tables capped at {DLRM_ROW_CAP} rows (a cut of "
                    f"scale): {rows} rows, "
                    f"{MC.count_params(specs) * 4 / 1e9:.2f} GB float32, "
                    f"initialised on the card in {time.time() - t0:.2f}s")
    t0 = time.time()
    batches = {}
    for cell in ("serve_p99", "serve_bulk"):
        b_size, n = DLRM_CELLS[cell]
        spec = DLRMBatchSpec(b_size, cfg.n_dense, cfg.n_sparse, cfg.vocabs,
                             seed=opts.seed)
        batches[cell] = [{k: v for k, v in dlrm_batch(spec, r).items()
                          if k != "labels"} for r in range(n)]
    rng = np.random.default_rng(opts.seed)
    batches["retrieval_cand"] = dict(
        dense=batches["serve_p99"][0]["dense"][:1],
        candidates=rng.integers(0, cfg.vocabs[0], size=(
            1, DLRM_CELLS["retrieval_cand"])).astype(np.int32))
    phase("models", f"dlrm batches generated on the host in "
                    f"{time.time() - t0:.2f}s")
    got = dlrm_pass(dev, model, cfg, batches, kernel=True)
    with unittest.mock.patch.object(DM, "embedding_bag", plain_lookup):
        want = dlrm_pass(dev, model, cfg, batches, kernel=False)
    for i, (g, w) in enumerate(zip(got["outputs"], want["outputs"])):
        if not torch.equal(g, w):
            fail(f"models: dlrm output {i} through the kernel != the plain "
                 f"lookup's (max abs diff {(g - w).abs().max()})")
        if not bool(torch.isfinite(g).all()):
            fail(f"models: dlrm output {i} is not finite")
    phase("models", f"dlrm: all {len(got['outputs'])} outputs (serve_p99, "
                    f"serve_bulk, retrieval_cand) through the kernel == the "
                    f"plain lookup, bit for bit")
    bulk = {k: torch.from_numpy(v).to(dev)
            for k, v in batches["serve_bulk"][0].items()}
    with torch.no_grad():
        device_profile(f"dlrm serve_bulk B={DLRM_CELLS['serve_bulk'][0]} "
                       f"(kernel)",
                       lambda: DM.serve_step(model, bulk, cfg))
    launches = got["launches"]
    del model, got, want, bulk
    torch.cuda.empty_cache()
    return launches


def lm_decode_at_width(dev, opts) -> None:
    """Phase 18, third part: gemma3-1b at full width and depth decoding
    against a 32k cache, then the 2-layer float32 card-against-CPU check."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import gemma3_1b
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.models import common as MC
    from repro_torch.models import transformer as TM

    cfg = gemma3_1b.CONFIG
    B, S, steps = (LM_DECODE[k] for k in ("batch", "seq", "steps"))
    start = S - steps
    torch.cuda.synchronize()
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    model = TM.Transformer(cfg, MC.init_params(TM.param_specs(cfg), gen,
                                               dev))
    ((k_shape, dt), _), _ = TM.make_kv_cache_specs(cfg, B, S)
    kc = torch.randn(k_shape, generator=gen, dtype=dt, device=dev)
    vc = torch.randn(k_shape, generator=gen, dtype=dt, device=dev)
    torch.cuda.synchronize()
    cache_gb = 2 * kc.numel() * kc.element_size() / 1e9
    phase("models", f"gemma3-1b: {cfg.n_layers} layers, d_model "
                    f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.n_params()} "
                    f"parameters in bfloat16; cache {B} x {S} positions "
                    f"({cache_gb:.2f} GB) from a seeded generator; set up "
                    f"in {time.time() - t0:.2f}s")
    tok = torch.from_numpy(lm_batch(LMBatchSpec(B, 1, cfg.vocab,
                                                seed=opts.seed), 0)
                           ["tokens"]).to(dev)
    kernels.reset_launch_counts()
    ms = []
    timed = steps - LM_DECODE["profiled"]
    with torch.no_grad():
        def step(n):
            nonlocal tok
            logits, _ = TM.serve_step(model, (kc, vc), tok, n, cfg)
            if not bool(torch.isfinite(logits).all()):
                fail(f"models: gemma3-1b logits not finite at step {n}")
            tok = logits.argmax(-1)[:, None].to(torch.int32)

        for n in range(start, start + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(n)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        device_profile(f"gemma3-1b decode, {LM_DECODE['profiled']} steps "
                       f"at cache_len {start + timed}",
                       lambda: [step(n) for n in range(start + timed,
                                                       start + steps)])
    if any(launch_counts().values()):
        fail(f"models: the LM decode launched a kernel: {launch_counts()}")
    warm = np.asarray(ms[1:])
    p50 = float(np.percentile(warm, 50))
    phase("models", f"gemma3-1b decode B={B} cache_len {start}..{S - 1}: "
                    f"step p50_ms={p50} min_ms={warm.min()} max_ms="
                    f"{warm.max()} (first step {ms[0]} ms left out), "
                    f"tok_per_s={B / p50 * 1e3} ({timed} steps timed one "
                    f"by one, host clock, each synchronised; all "
                    f"{steps} steps' logits finite)")
    del model, kc, vc
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=LM_CHECK["layers"],
                                dtype=torch.float32)
    t0 = time.time()
    gen = torch.Generator().manual_seed(opts.seed)
    params = MC.init_params(TM.param_specs(small), gen, "cpu")
    ((k_shape, dt), _), _ = TM.make_kv_cache_specs(small, LM_CHECK["batch"],
                                                   LM_CHECK["seq"])
    kc = torch.randn(k_shape, generator=gen, dtype=dt)
    vc = torch.randn(k_shape, generator=gen, dtype=dt)
    runs = {"cpu": (TM.Transformer(small, params), kc.clone(), vc.clone()),
            "card": (TM.Transformer(small, params).to(dev),
                     kc.to(dev), vc.to(dev))}
    toks = {d: torch.zeros((LM_CHECK["batch"], 1), dtype=torch.int32,
                           device=k.device) for d, (_, k, _) in runs.items()}
    worst = 0.0
    with torch.no_grad():
        for n in range(LM_CHECK["start"], LM_CHECK["start"]
                       + LM_CHECK["steps"]):
            out = {d: TM.serve_step(m, (k, v), toks[d], n, small)[0]
                   for d, (m, k, v) in runs.items()}
            want, got = out["cpu"], out["card"].cpu()
            rel = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
            if rel > 1e-4 or not torch.equal(got.argmax(-1),
                                             want.argmax(-1)):
                fail(f"models: 2-layer float32 decode on the card != CPU at "
                     f"step {n} (max diff / max logit {rel})")
            toks = {d: out[d].argmax(-1)[:, None].to(torch.int32)
                    for d in out}
    phase("models", f"gemma3-1b widths, {LM_CHECK['layers']} layers, "
                    f"float32, batch {LM_CHECK['batch']}, cache "
                    f"{LM_CHECK['seq']}, {LM_CHECK['steps']} steps from "
                    f"{LM_CHECK['start']}: card == CPU (max diff / max "
                    f"logit {worst:.3e}, tolerance 1e-4; greedy tokens "
                    f"equal) in {time.time() - t0:.1f}s")


def models_phase(dev, opts) -> int:
    """Phase 18 (see the module docstring); returns ``embedding_bag``'s
    launches on its paths."""
    import torch

    t0 = time.time()
    torch.cuda.empty_cache()
    phase("models", f"device memory allocated at start "
                    f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    launches = cli_models(dev, opts)
    launches += dlrm_at_width(dev, opts)
    lm_decode_at_width(dev, opts)
    phase("models", f"phase seconds={time.time() - t0:.1f}")
    return launches


def train_cli(dev, opts) -> None:
    """Phase 19, first part: ``launch.train`` on the SMOKE configs.
    gemma3-1b for 21 steps saving every 10, then the same checkpoint for
    31 (it must restore step 20 and run steps 21-30 only), then
    qwen3-moe-235b-a22b for 11; every printed loss finite."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch import train as train_cli

    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = (("gemma3-1b", 21, [0, 10, 20], []),
            ("gemma3-1b", 31, [30], [("restored", 20)]),
            ("qwen3-moe-235b-a22b", 11, [0, 10], []))
    for arch, steps, printed, restored in runs:
        if arch != "gemma3-1b":
            shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.time()
        out = train_cli.main(["--arch", arch, "--steps", str(steps),
                              "--save-every", "10", "--device", dev.type,
                              "--seed", str(opts.seed), "--ckpt", str(ckpt)])
        torch.cuda.synchronize()
        got = [e for e in out["events"] if e[0] == "restored"]
        phase("train", f"cli --arch {arch} --steps {steps}: losses="
                       f"{out['losses']} events={out['events']} "
                       f"seconds={time.time() - t0:.2f}")
        if sorted(out["losses"]) != printed or got != restored:
            fail(f"train: cli {arch} --steps {steps} printed steps "
                 f"{sorted(out['losses'])} with {got}, expected {printed} "
                 f"with {restored}")
        if not all(np.isfinite(v) for v in out["losses"].values()):
            fail(f"train: cli {arch} printed a loss that is not finite")
        if int(out["state"]["opt"].step) != steps:
            fail(f"train: cli {arch} ended at optimizer step "
                 f"{int(out['state']['opt'].step)}, not {steps}")
    shutil.rmtree(ckpt, ignore_errors=True)


def lm_train_at_width(dev, opts) -> None:
    """Phase 19, second part: gemma3-1b at full width and depth (bfloat16)
    taking AdamW steps at ``train_4k``'s seq on one ``lm_batch``, timed
    step by step, one more step under torch.profiler."""
    import numpy as np
    import torch

    from repro_torch.configs import gemma3_1b
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.models import common as MC
    from repro_torch.models import transformer as TM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import train_step

    cfg = gemma3_1b.CONFIG
    B, T = LM_TRAIN["batch"], LM_TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    params = MC.init_params(TM.param_specs(cfg), gen, dev)
    ostate = opt.adamw_init(params)
    ocfg = opt.AdamWConfig(lr=LM_TRAIN["lr"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in lm_batch(
        LMBatchSpec(B, T, cfg.vocab, seed=opts.seed), 0).items()}
    torch.cuda.synchronize()
    n = cfg.n_params()
    gb = 1e9
    phase("train", f"gemma3-1b: {cfg.n_layers} layers, d_model "
                   f"{cfg.d_model}, vocab {cfg.vocab}, {n} parameters in "
                   f"bfloat16, B={B} T={T} (train_4k's seq; batch cut from "
                   f"256), attn_chunk {cfg.attn_chunk}, loss_chunks "
                   f"{cfg.loss_chunks}, remat {cfg.remat}; set up in "
                   f"{time.time() - t0:.2f}s; from the code: weights "
                   f"{2 * n / gb:.2f} GB + grads {2 * n / gb:.2f} GB + "
                   f"AdamW moments {8 * n / gb:.2f} GB, a loss chunk's "
                   f"float32 logits "
                   f"{B * T // cfg.loss_chunks * cfg.vocab * 4 / gb:.2f} "
                   f"GB, a layer's remat residual "
                   f"{B * T * cfg.d_model * 2 / gb:.3f} GB")
    kernels_before = sum(launch_counts().values())
    losses, ms = [], []
    state = (params, ostate)
    for i in range(LM_TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, p2, o2 = train_step(*state, batch, cfg, opt.adamw_update,
                                  ocfg)
        state = (p2, o2)
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(losses[-1]):
            fail(f"train: gemma3-1b loss at step {i} is not finite")
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        fail(f"train: gemma3-1b loss did not fall: {losses}")
    p50 = float(np.percentile(ms[1:], 50))
    phase("train", f"gemma3-1b train B={B} T={T}: losses={losses}; step "
                   f"ms={ms}; p50_ms (steps 2-{len(ms)})={p50} tok_per_s="
                   f"{B * T / p50 * 1e3} max_memory_allocated="
                   f"{peak / gb:.2f} GB (host clock, each step "
                   f"synchronised)")

    def one():
        nonlocal state
        _, p2, o2 = train_step(*state, batch, cfg, opt.adamw_update, ocfg)
        state = (p2, o2)

    device_profile(f"gemma3-1b train step B={B} T={T}", one, top=15,
                   cpu_ops=False)
    if sum(launch_counts().values()) != kernels_before:
        fail(f"train: the LM training path launched a kernel of the port: "
             f"{launch_counts()}")
    del state, params, ostate, batch
    torch.cuda.empty_cache()


def _named_grads(model) -> dict:
    return {k: p.grad for k, p in model.named_parameters()}


def train_card_vs_cpu(dev, opts) -> None:
    """Phase 19, third part: gemma3-1b's widths at 2 layers in float32 (no
    TF32), B 1, T 640 so the 512-token window masks: ``loss_fn`` and every
    weight's gradient on the card and on the CPU from one seed."""
    import dataclasses

    import torch

    from repro_torch.configs import gemma3_1b
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.models import common as MC
    from repro_torch.models import transformer as TM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(gemma3_1b.CONFIG, n_layers=TRAIN_CHECK["layers"],
                              dtype=torch.float32)
    t0 = time.time()
    params = MC.init_params(TM.param_specs(cfg),
                            torch.Generator().manual_seed(opts.seed), "cpu")
    b = lm_batch(LMBatchSpec(TRAIN_CHECK["batch"], TRAIN_CHECK["seq"],
                             cfg.vocab, seed=opts.seed), 0)
    res = {}
    for where in ("cpu", dev):
        tree = MC.nest({k: t.to(where) for k, t in MC._leaves(params)})
        model = TM.Transformer(cfg, tree, trainable=True)
        loss = TM.loss_fn(model, {k: torch.from_numpy(v).to(where)
                                  for k, v in b.items()}, cfg)
        loss.backward()
        res[str(where)] = (float(loss.detach()), {k: g.cpu() for k, g in
                                         _named_grads(model).items()})
        del model, tree
    (lc, gc), (lg, gg) = res["cpu"], res[str(dev)]
    rel = abs(lg - lc) / abs(lc)
    worst = max((float((gg[k] - w).abs().max() / w.abs().max()), k)
                for k, w in gc.items())
    phase("train", f"gemma3-1b widths, {cfg.n_layers} layers, float32, "
                   f"B={TRAIN_CHECK['batch']} T={TRAIN_CHECK['seq']}: loss "
                   f"card {lg} cpu {lc} (rel {rel:.3e}, tolerance 1e-5); "
                   f"worst gradient {worst[1]} {worst[0]:.3e} of its "
                   f"largest (tolerance 1e-4) in {time.time() - t0:.1f}s")
    if rel > 1e-5 or worst[0] > 1e-4:
        fail("train: the float32 loss or gradients on the card != CPU")
    torch.cuda.empty_cache()


def moe_at_width(dev, opts) -> None:
    """Phase 19, fourth part: qwen3-moe-235b-a22b at full width cut to 2
    layers (bfloat16), B 1 at ``train_4k``'s seq: ``prefill_step``'s
    logits finite, the share of expert assignments kept at capacity, and
    one train step with Adafactor."""
    import dataclasses
    import unittest.mock

    import numpy as np
    import torch

    from repro_torch.configs import qwen3_moe_235b
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.models import common as MC
    from repro_torch.models import transformer as TM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import train_step

    cfg = dataclasses.replace(qwen3_moe_235b.CONFIG,
                              n_layers=MOE_TRAIN["layers"])
    B, T = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    params = MC.init_params(TM.param_specs(cfg), gen, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in lm_batch(
        LMBatchSpec(B, T, cfg.vocab, seed=opts.seed), 0).items()}
    torch.cuda.synchronize()
    phase("train", f"qwen3-moe-235b-a22b widths, {cfg.n_layers} of 94 "
                   f"layers: {cfg.n_params()} parameters "
                   f"({2 * cfg.n_params() / 1e9:.2f} GB bfloat16), "
                   f"{cfg.moe_experts} experts top-{cfg.moe_top_k}, B={B} "
                   f"T={T}; set up in {time.time() - t0:.2f}s")
    kept = []
    dispatch = TM._dispatch

    def counting(flat_e, E, cap):
        keep, slot = dispatch(flat_e, E, cap)
        kept.append((int(keep.sum()), keep.numel(), cap))
        return keep, slot

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), unittest.mock.patch.object(TM, "_dispatch",
                                                     counting):
        logits = TM.prefill_step(TM.Transformer(cfg, params),
                                 batch["tokens"], cfg)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits).all()):
        fail("train: qwen3-moe prefill logits are not finite")
    share = sum(k for k, _, _ in kept) / sum(n for _, n, _ in kept)
    phase("train", f"qwen3-moe prefill B={B} T={T}: logits finite "
                   f"{tuple(logits.shape)}, {pre_ms:.1f} ms (first call); "
                   f"assignments kept at capacity by layer (kept, of, cap): "
                   f"{kept}, share {share:.4f}")
    ostate = opt.adafactor_init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, p2, _ = train_step(params, ostate, batch, cfg,
                             opt.adafactor_update, opt.AdafactorConfig())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not np.isfinite(float(loss)) or not all(
            bool(torch.isfinite(x).all()) for x in opt.leaves(p2)):
        fail("train: qwen3-moe train step gave a loss or weights that are "
             "not finite")
    phase("train", f"qwen3-moe Adafactor train step B={B} T={T}: loss="
                   f"{float(loss)} {ms:.1f} ms (one step, host clock, "
                   f"synchronised) max_memory_allocated="
                   f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params, p2, ostate, logits, batch
    torch.cuda.empty_cache()


def train_phase(dev, opts) -> None:
    """Phase 19 (see the module docstring)."""
    import torch

    t0 = time.time()
    torch.cuda.empty_cache()
    kernels_before = sum(launch_counts().values())
    parts = []
    for part in (train_cli, lm_train_at_width, train_card_vs_cpu,
                 moe_at_width):
        t = time.time()
        part(dev, opts)
        parts.append(f"{part.__name__} {time.time() - t:.1f}s")
    if sum(launch_counts().values()) != kernels_before:
        fail(f"train: the training path launched a kernel of the port: "
             f"{launch_counts()}")
    phase("train", f"phase seconds={time.time() - t0:.1f} "
                   f"({', '.join(parts)})")


def arch_smokes(dev) -> dict:
    """Phase 20 (a): ``configs.dlrm_mlperf.smoke`` and each GNN config's
    ``smoke`` on the card, launch counts reset just before and read just
    after: ``embedding_bag`` forward and backward on DLRM's, ``segment_sum``
    on the GNNs', and neither ``segment_fused`` nor ``wedge_intersect``.
    Returns the launches by kernel."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import (
        dimenet_cfg, dlrm_mlperf, equiformer_v2_cfg, gatedgcn_cfg,
        graphsage_reddit,
    )

    total = {}
    for mod, need in ((dlrm_mlperf, ("embedding_bag",
                                     "embedding_bag_backward")),
                      (graphsage_reddit, ("segment_sum",)),
                      (gatedgcn_cfg, ("segment_sum",)),
                      (dimenet_cfg, ("segment_sum",)),
                      (equiformer_v2_cfg, ("segment_sum",))):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        mod.smoke(device=dev.type)
        torch.cuda.synchronize()
        n = launch_counts()
        name = mod.__name__.rsplit(".", 1)[1]
        phase("train-archs", f"smoke {name}: launches={n} "
                             f"seconds={time.time() - t0:.2f}")
        if any(n[k] <= 0 for k in need) or any(
                v for k, v in n.items() if k not in need):
            fail(f"train-archs: smoke {name} launched {n}; expected "
                 f"{need} only")
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    return total


def train_steps(dev, label: str, module, cfg, params, batch, steps: int,
                lr: float, falling: bool) -> dict:
    """AdamW steps (``train.step.train_step``) on one batch, each timed on
    the host clock to its synchronised end; every loss finite and, when
    ``falling``, the last below the first; launch counts reset before the
    first step and read after the last.  ``module`` is a model module
    (``models.dlrm`` or one of ``models.gnn.*``: its ``MODEL`` and
    ``loss_fn``).  Returns the losses, ms,
    launches, peak memory and the state after the last step."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import train_step

    cls = module.MODEL
    ocfg = opt.AdamWConfig(lr=lr)
    state = (params, opt.adamw_init(params))
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, ms, peaks = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, p2, o2 = train_step(*state, batch, cfg, opt.adamw_update,
                                  ocfg, model_cls=cls,
                                  loss_fn=module.loss_fn)
        state = (p2, o2)
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        if not np.isfinite(losses[-1]):
            fail(f"train-archs: {label} loss at step {i} is not finite")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if falling and not losses[-1] < losses[0]:
        fail(f"train-archs: {label} loss did not fall: {losses}")
    p50 = float(np.percentile(ms[1:5], 50))
    phase("train-archs", f"{label}: {steps} AdamW steps (lr {lr}) losses="
                         f"{losses}; step ms={ms}; p50_ms (steps 2-"
                         f"{min(steps, 5)})={p50} max_memory_allocated="
                         f"{peak / 1e9:.2f} GB (after each step "
                         f"{[round(x / 1e9, 2) for x in peaks]}) "
                         f"launches={counts} (host clock, each step "
                         f"synchronised)")
    return dict(losses=losses, ms=ms, p50=p50, launches=counts, peak=peak,
                state=state, step=lambda s: train_step(
                    *s, batch, cfg, opt.adamw_update, ocfg, model_cls=cls,
                    loss_fn=module.loss_fn))


def profile_step(label: str, run: dict) -> None:
    """One more step of ``train_steps``' run under torch.profiler: busy
    share, device time by kernel and by op."""
    def one():
        run["state"] = run["step"](run["state"])[1:]

    device_profile(label, one, top=12)


def dlrm_train_at_width(dev, opts) -> dict:
    """Phase 20 (b): dlrm-mlperf at the MLPerf widths (embed 128, full
    bottom and top MLPs), every table capped at ``DLRM_TRAIN['row_cap']``
    rows, at ``train_batch``'s B: AdamW steps on one ``dlrm_batch``, one
    more step profiled; then the backward kernel timed on the batch's ids
    into the largest capped table and into each table of 155 rows or
    fewer (8 of them: hot rows).  Returns the launches and the capped
    table's backward timings."""
    import dataclasses

    import torch

    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data.pipeline import DLRMBatchSpec, dlrm_batch
    from repro_torch.models import common as MC
    from repro_torch.models import dlrm as DM

    cap, B = DLRM_TRAIN["row_cap"], DLRM_TRAIN["batch"]
    cfg = dataclasses.replace(dlrm_mlperf.CONFIG, vocabs=tuple(
        min(v, cap) for v in DM.MLPERF_VOCABS))
    specs = DM.param_specs(cfg)
    rows = sum(s.shape[0] for s in specs["tables"].values())
    torch.cuda.synchronize()
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    # the steps own the weights: no other reference keeps the first ones
    state = [MC.init_params(specs, gen, dev)]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in dlrm_batch(
        DLRMBatchSpec(B, cfg.n_dense, cfg.n_sparse, cfg.vocabs,
                      seed=opts.seed), 0).items()}
    torch.cuda.synchronize()
    gb = MC.count_params(specs) * 4 / 1e9
    before = torch.cuda.memory_allocated()
    phase("train-archs", f"dlrm-mlperf widths (embed {cfg.embed_dim}, bot "
                         f"{cfg.bot_mlp}, top {(cfg.top_in,) + cfg.top_mlp})"
                         f", tables capped at {cap} rows (a cut of scale): "
                         f"{rows} rows, {gb:.2f} GB float32 a copy (weights, "
                         f"grads, two AdamW moments, the update's new "
                         f"weights and moments), B={B} (train_batch); set "
                         f"up in {time.time() - t0:.2f}s; device memory "
                         f"allocated {before / 1e9:.2f} GB")
    run = train_steps(dev, f"dlrm train B={B}", DM, cfg, state.pop(),
                      batch, DLRM_TRAIN["steps"], DLRM_TRAIN["lr"], True)
    n = run["launches"]
    per_step = cfg.n_sparse * DLRM_TRAIN["steps"]
    if n != {**{k: 0 for k in n}, "embedding_bag": per_step,
             "embedding_bag_backward": per_step}:
        fail(f"train-archs: dlrm training launched {n}, expected "
             f"{per_step} embedding_bag and embedding_bag_backward")
    phase("train-archs", f"dlrm train B={B}: samples_per_s="
                         f"{B / run['p50'] * 1e3}")
    profile_step(f"dlrm train step B={B}", run)
    del run
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(opts.seed + 1)
    out, err = {}, 0.0
    small = sorted((t for t in range(cfg.n_sparse) if cfg.vocabs[t] <= 155),
                   key=lambda i: cfg.vocabs[i])
    for t in [max(range(cfg.n_sparse), key=lambda i: cfg.vocabs[i])] + small:
        v = specs["tables"][f"t{t}"].shape[0]
        idx = batch["sparse"][:, t:t + 1].contiguous()
        cot = torch.randn((B, cfg.embed_dim), generator=gen, device=dev)
        res = time_embedding_bag_bwd(
            f"embedding_bag_bwd dlrm table t{t} (V={v}) B={B} K=1 float32",
            cot, idx, torch.ones((B, 1), device=dev), v, opts.reps)
        out, err = out or res, max(err, res["max_abs_err"])
    return dict(launches=n, capped=out, max_abs_err=err)


def fanout_graph(seeds: int):
    """A generated graph for ``seeds`` seed nodes at fanouts (15, 10),
    degree >= 16 everywhere the sampler reaches: node ids 0 .. seeds - 1
    are the seeds, each with 16 children (layer A); each A node has its
    parent and 16 children (layer B); each B node its parent and the 16 B
    nodes within 8 of it on a ring.  A seed's 15 samples are always new
    nodes, so the sampled subgraph has minibatch_lg's 168,960 edges at
    1,024 seeds (its nodes fall short of 169,984 where an A node samples
    its parent).  Built row by row in CSR order (no sort of the edge
    list).  Returns the graph and the seeds' ids."""
    import numpy as np

    from repro_torch.core.graph import Graph

    k = SEGMENT_SUM_SIZE["fanouts"][0] + 1
    n_a, n_b = seeds * k, seeds * k * k
    a0, b0 = seeds, seeds + n_a
    s_rows = a0 + np.arange(n_a).reshape(seeds, k)
    a_rows = np.concatenate([(np.arange(n_a) // k)[:, None],
                             b0 + np.arange(n_b).reshape(n_a, k)], 1)
    j = np.arange(n_b)[:, None]
    offs = np.concatenate([np.arange(-8, 0), np.arange(1, 9)])
    b_rows = np.concatenate([(a0 + np.arange(n_b) // k)[:, None],
                             b0 + np.sort((j + offs) % n_b, axis=1)], 1)
    deg = np.concatenate([np.full(seeds, k), np.full(n_a, k + 1),
                          np.full(n_b, 2 * 8 + 1)])
    indptr = np.zeros(deg.shape[0] + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    g = Graph(indptr=indptr, indices=np.concatenate(
        [s_rows.ravel(), a_rows.ravel(), b_rows.ravel()]).astype(np.int32),
        weights=np.ones(deg.shape[0], dtype=np.int32))
    return g, np.arange(seeds)


def sampled_batch(dev, g, seeds, cfg, seed: int) -> dict:
    """A graphsage batch from ``sample_fanout`` at the ``seeds`` node ids
    and fanouts (15, 10), padded to the no-repeat layout's counts (seeds x
    (1 + 15 + 150) nodes, seeds x 165 edges): node features and labels
    drawn from the seed on ``dev``, the loss on the seeds."""
    import numpy as np
    import torch

    from repro_torch.graphs.sampler import sample_fanout

    fan = SEGMENT_SUM_SIZE["fanouts"]
    n_seeds = len(seeds)
    n_sub = n_seeds * (1 + fan[0] + fan[0] * fan[1])
    e_sub = n_seeds * (fan[0] + fan[0] * fan[1])
    sub = sample_fanout(g, seeds, fan, rng=np.random.default_rng(seed),
                        pad_nodes=n_sub, pad_edges=e_sub)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.zeros(n_sub, device=dev)
    mask[:n_seeds] = 1.0
    return dict(
        node_feat=torch.randn((n_sub, cfg.d_feat), generator=gen,
                              device=dev),
        row=torch.from_numpy(sub.row).to(dev),
        col=torch.from_numpy(sub.col).to(dev),
        labels=torch.randint(0, cfg.n_classes, (n_sub,), generator=gen,
                             device=dev, dtype=torch.int32),
        label_mask=mask, n_valid=sub.n_valid)


def full_graph_batch(dev, cfg, shape: dict, seed: int) -> dict:
    """A full-graph batch at a GNN shape's sizes, padded as the reference's
    ``gnn_build`` pads (src/repro/configs/base.py:283-284): N =
    pad_multiple(n_nodes) rows, E2 = pad_multiple(2 n_edges) slots; a
    generated G(n, m) graph of ``n_edges`` undirected edges fills
    2 n_edges of them, the rest are padding on the sentinel N."""
    import numpy as np
    import torch

    from repro_torch.graphs.generators import gnm

    N, E2 = pad512(shape["n_nodes"]), pad512(2 * shape["n_edges"])
    g = gnm(shape["n_nodes"], shape["n_edges"], seed=seed)
    row = np.full(E2, N, np.int32)
    col = np.full(E2, N, np.int32)
    row[:g.num_directed_edges] = g.edge_sources()
    col[:g.num_directed_edges] = g.indices
    gen = torch.Generator(device=dev).manual_seed(seed)
    return dict(
        node_feat=torch.randn((N, cfg.d_feat), generator=gen, device=dev),
        row=torch.from_numpy(row).to(dev), col=torch.from_numpy(col).to(dev),
        labels=torch.randint(0, cfg.n_classes, (N,), generator=gen,
                             device=dev, dtype=torch.int32),
        label_mask=(torch.arange(N, device=dev) < shape["n_nodes"]).float())


def molecule_batch(dev, shape: dict, seed: int) -> dict:
    """``molecule``'s batch: n_graphs graphs of n_nodes / n_graphs atoms
    (3-D positions ~ N(0, 1.5^2), inside the 5.0 cutoff), each with
    2 n_edges / n_graphs directed edges (random distinct pairs, both
    directions), E2 = pad_multiple(2 n_edges) slots; triplets from
    ``build_triplets`` at the reference's budget min(8 E2, 2^24)
    (src/repro/configs/base.py:308); energies drawn from the seed."""
    import numpy as np
    import torch

    from repro_torch.graphs.sampler import build_triplets

    G_, N = shape["n_graphs"], shape["n_nodes"]
    per, pairs = N // G_, shape["n_edges"] // G_
    E2 = pad512(2 * shape["n_edges"])
    rng = np.random.default_rng(seed)
    iu = np.stack(np.triu_indices(per, 1), 1)
    rows, cols = [], []
    for m in range(G_):
        e = iu[rng.choice(iu.shape[0], pairs, replace=False)] + m * per
        rows += [e[:, 0], e[:, 1]]
        cols += [e[:, 1], e[:, 0]]
    row = np.full(E2, N, np.int32)
    col = np.full(E2, N, np.int32)
    real = np.concatenate(rows).shape[0]
    row[:real], col[:real] = np.concatenate(rows), np.concatenate(cols)
    t0 = time.time()
    tri = build_triplets(row, col, N, budget=min(8 * E2, 1 << 24))
    phase("train-archs", f"molecule: {G_} graphs x {per} atoms, {real} "
                         f"directed edges of {E2} slots, "
                         f"{int((tri[:, 0] < E2).sum())} triplets of a "
                         f"{tri.shape[0]} budget (build_triplets "
                         f"{time.time() - t0:.2f}s on the host)")
    return dict(
        node_feat=torch.from_numpy(rng.normal(size=(N, 16)).astype(
            np.float32)).to(dev),
        pos=torch.from_numpy((1.5 * rng.normal(size=(N, 3))).astype(
            np.float32)).to(dev),
        row=torch.from_numpy(row).to(dev), col=torch.from_numpy(col).to(dev),
        triplets=torch.from_numpy(tri).to(dev),
        batch_id=torch.from_numpy(np.arange(N, dtype=np.int32) // per
                                  ).to(dev),
        energy=torch.from_numpy(rng.normal(size=G_).astype(np.float32)
                                ).to(dev),
        labels=torch.zeros(N, dtype=torch.int32, device=dev),
        label_mask=torch.ones(N, device=dev), n_graphs=G_)


def pad512(x: int) -> int:
    """``configs/base.py``'s ``pad_multiple`` (512)."""
    return (x + 511) // 512 * 512


def gnn_train(dev, opts, label: str, module, cfg, batch: dict, steps: int,
              falling: bool, profiled: bool) -> dict:
    """A GNN's AdamW steps at a CONFIG's widths (``train_steps``), the
    forward's plan building timed on its own (host packing of every
    segment array, the host copy of the segments included)."""
    import torch

    from repro_torch.models import common as MC

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plans = module.plans(batch, cfg)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    flat = [p for v in plans.values()
            for p in (v if isinstance(v, list) else [v])]
    phase("train-archs", f"{label}: plans a forward: {len(flat)}, host "
                         f"time {plan_ms:.2f} ms; (rows, E_BLK) "
                         f"{[(p.n, p.lrow.shape[1]) for p in flat]}")
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    run = train_steps(dev, label, module, cfg,
                      MC.init_params(module.param_specs(cfg), gen, dev),
                      {k: v for k, v in batch.items() if k != "n_valid"},
                      steps, GNN_TRAIN["lr"], falling)
    if run["launches"]["segment_sum"] <= 0 or any(
            v for k, v in run["launches"].items() if k != "segment_sum"):
        fail(f"train-archs: {label} launched {run['launches']}")
    if profiled:
        profile_step(f"{label} train step", run)
    return run


def gnns_at_width(dev, opts) -> dict:
    """Phase 20 (c)-(e): graphsage-reddit at ``minibatch_lg`` (the sampler
    on a generated graph), gatedgcn at ``full_graph_sm``, dimenet and
    equiformer-v2 at ``molecule`` (their CONFIGs, d_feat as the shape
    gives it); then ``segment_sum`` timed on graphsage's real plan at its
    first layer's payload.  Returns the launches and that timing."""
    import dataclasses

    import torch

    from repro_torch.configs import (
        dimenet_cfg, equiformer_v2_cfg, gatedgcn_cfg, graphsage_reddit,
    )
    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.kernels.segment_coo.cost import segment_sum_work
    from repro_torch.kernels.segment_coo.ops import segment_sum_plain

    t0 = time.time()
    g, seeds = fanout_graph(SEGMENT_SUM_SIZE["seeds"])
    gs_cfg = graphsage_reddit.CONFIG
    batch = sampled_batch(dev, g, seeds, gs_cfg, opts.seed)
    phase("train-archs", f"graphsage-reddit minibatch_lg: generated graph "
                         f"n={g.n} (min degree {int(g.degrees().min())}), "
                         f"sample_fanout of {len(seeds)} "
                         f"seeds at {SEGMENT_SUM_SIZE['fanouts']}: "
                         f"{batch['n_valid']} real nodes of "
                         f"{batch['node_feat'].shape[0]}, "
                         f"{int((batch['row'] < batch['node_feat'].shape[0]).sum())}"
                         f" edges of {batch['row'].shape[0]} "
                         f"(host {time.time() - t0:.2f}s)")
    launches = {}
    runs = [("graphsage-reddit minibatch_lg", graphsage_reddit.module,
             gs_cfg, batch, GNN_TRAIN["steps"], True, True)]
    shape = GNN_SHAPES["full_graph_sm"]
    gg_cfg = dataclasses.replace(gatedgcn_cfg.CONFIG,
                                 d_feat=shape["d_feat"])
    runs.append(("gatedgcn full_graph_sm", gatedgcn_cfg.module, gg_cfg,
                 full_graph_batch(dev, gg_cfg, shape, opts.seed),
                 GNN_TRAIN["short_steps"], False, False))
    mol = molecule_batch(dev, GNN_SHAPES["molecule"], opts.seed)
    for name, mod in (("dimenet", dimenet_cfg), ("equiformer-v2",
                                                  equiformer_v2_cfg)):
        runs.append((f"{name} molecule", mod.module, mod.CONFIG, mol,
                     GNN_TRAIN["short_steps"], False, False))
    for label, module, cfg, b, steps, falling, profiled in runs:
        run = gnn_train(dev, opts, label, module, cfg, b, steps, falling,
                        profiled)
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        del run
        torch.cuda.empty_cache()
    # segment_sum on graphsage's own plan: layer 1's payload hp[row]
    plan = graphsage_reddit.module.plans(batch, gs_cfg)["col"]
    n = batch["node_feat"].shape[0]
    hp = torch.cat([batch["node_feat"], batch["node_feat"].new_zeros(
        (1, gs_cfg.d_feat))])
    data = hp[batch["row"].long()].contiguous()
    got, _ = run_op("segment_sum", lambda: K.segment_sum(
        data, plan.edge_perm, plan.lrow, n, r_blk=plan.r_blk))
    check_segment_sum(got, data, plan.edge_perm, plan.lrow, n, plan.r_blk,
                      "segment_sum graphsage plan")
    live = (plan.lrow < plan.r_blk).sum()
    t = timings("segment_sum graphsage plan", lambda: K.segment_sum(
        data, plan.edge_perm, plan.lrow, n, r_blk=plan.r_blk),
        lambda: segment_sum_plain(data, plan.edge_perm, plan.lrow, n,
                                  r_blk=plan.r_blk), None, opts.reps,
        segment_sum_work(data, plan.edge_perm, plan.lrow, n,
                         r_blk=plan.r_blk))
    phase("train-archs", f"segment_sum on graphsage's real plan (D "
                         f"{gs_cfg.d_feat} float32, {int(live)} live of "
                         f"{plan.lrow.numel()} slots): kernel_ms="
                         f"{t['ms']:.5f} beside phase 12's layout")
    return dict(launches=launches, graphsage_plan=t)


def train_archs_card_vs_cpu(dev, opts) -> None:
    """Phase 20 (f): float32 (no TF32), one seed: DLRM's SMOKE, each GNN's
    SMOKE on the smoke runner's graph (equiformer's act_dtype float32; the
    molecular ones against energies of 1, so that the gradients are not
    scaled by the init's ~1e-6 energies), and
    graphsage-reddit's CONFIG on a 64-seed sample, on the card and on the
    CPU: the loss within 1e-5 relative and every weight's gradient within
    1e-4 of its largest (a gradient that is exactly 0, as equiformer's
    w_att_dst's, within 1e-6 of the model's largest)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import (
        dimenet_cfg, dlrm_mlperf, equiformer_v2_cfg, gatedgcn_cfg,
        graphsage_reddit,
    )
    from repro_torch.configs.smoke_runners import (
        dlrm_smoke_batches, gnn_smoke_batch,
    )
    from repro_torch.models import common as MC
    from repro_torch.models import dlrm as DM
    from repro_torch.train.step import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("dlrm-mlperf SMOKE", DM, dlrm_mlperf.SMOKE,
              dlrm_smoke_batches(dlrm_mlperf.SMOKE)[0])]
    for name, mod, mol, smp in (
            ("graphsage-reddit", graphsage_reddit, False, True),
            ("gatedgcn", gatedgcn_cfg, False, False),
            ("dimenet", dimenet_cfg, True, False),
            ("equiformer-v2", equiformer_v2_cfg, True, False)):
        cfg = mod.SMOKE
        if name == "equiformer-v2":
            cfg = dataclasses.replace(cfg, act_dtype=torch.float32)
        b = gnn_smoke_batch(cfg, molecular=mol, sampled=smp)
        if mol:  # targets of 1: the init's energies are ~1e-6
            b["energy"] = np.ones_like(b["energy"])
        cases.append((f"{name} SMOKE", mod.module, cfg, b))
    g, seeds = fanout_graph(GNN_TRAIN["check_seeds"])
    sb = sampled_batch(torch.device("cpu"), g, seeds,
                       graphsage_reddit.CONFIG, opts.seed + 1)
    sb.pop("n_valid")
    cases.append((f"graphsage-reddit CONFIG, {GNN_TRAIN['check_seeds']} "
                  f"seeds", graphsage_reddit.module, graphsage_reddit.CONFIG,
                  {k: v.numpy() for k, v in sb.items()}))
    for label, module, cfg, batch in cases:
        t0 = time.time()
        cls = module.MODEL
        params = MC.init_params(module.param_specs(cfg),
                                torch.Generator().manual_seed(opts.seed),
                                "cpu")
        if module is DM:  # weights x 8: logits of order one
            params = MC.nest({k: t * 8.0 for k, t in MC._leaves(params)})
        res = {}
        for where in ("cpu", dev):
            tree = MC.nest({k: t.to(where) for k, t in MC._leaves(params)})
            tb = {k: torch.from_numpy(v).to(where)
                  if isinstance(v, np.ndarray) else v
                  for k, v in batch.items()}
            loss, grads = loss_and_grads(tree, tb, cfg, model_cls=cls,
                                         loss_fn=module.loss_fn)
            res[str(where)] = (float(loss), {k: v.cpu() for k, v in
                                             MC._leaves(grads)})
        (lc, gc), (lg, gg) = res["cpu"], res[str(dev)]
        rel = abs(lg - lc) / abs(lc)
        floor = 1e-6 * max(float(w.abs().max()) for w in gc.values())
        worst = max((float((gg[k] - w).abs().max()
                           / max(float(w.abs().max()), floor)), k)
                    for k, w in gc.items())
        phase("train-archs", f"card vs cpu {label}, float32: loss card "
                             f"{lg} cpu {lc} (rel {rel:.3e}, tolerance "
                             f"1e-5); worst gradient {worst[1]} "
                             f"{worst[0]:.3e} of its largest (tolerance "
                             f"1e-4) in {time.time() - t0:.1f}s")
        if not rel <= 1e-5 or not worst[0] <= 1e-4:
            fail(f"train-archs: {label}: the float32 loss or gradients on "
                 f"the card != CPU")
    torch.cuda.empty_cache()


def train_archs_phase(dev, opts) -> dict:
    """Phase 20 (see the module docstring); returns the launches by kernel
    on its paths, the backward kernel's timings at the capped DLRM table
    and ``segment_sum``'s on graphsage's plan."""
    import torch

    t0 = time.time()
    torch.cuda.empty_cache()
    parts, launches = [], {}
    t = time.time()
    for k, v in arch_smokes(dev).items():
        launches[k] = launches.get(k, 0) + v
    parts.append(f"smokes {time.time() - t:.1f}s")
    t = time.time()
    dl = dlrm_train_at_width(dev, opts)
    parts.append(f"dlrm {time.time() - t:.1f}s")
    t = time.time()
    gn = gnns_at_width(dev, opts)
    parts.append(f"gnns {time.time() - t:.1f}s")
    t = time.time()
    train_archs_card_vs_cpu(dev, opts)
    parts.append(f"card vs cpu {time.time() - t:.1f}s")
    for counts in (dl["launches"], gn["launches"]):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    if launches.get("segment_fused") or launches.get("wedge_intersect"):
        fail(f"train-archs: segment_fused or wedge_intersect launched on "
             f"the training paths: {launches}")
    phase("train-archs", f"launches on the training paths: {launches}; "
                         f"phase seconds={time.time() - t0:.1f} "
                         f"({', '.join(parts)})")
    return dict(launches=launches, dlrm_bwd=dl["capped"],
                bwd_err=dl["max_abs_err"],
                graphsage_plan=gn["graphsage_plan"])


def to_device(tree, dev):
    """A copy of ``tree`` (tensors in dicts, lists and tuples, named ones
    included) on ``dev``; other leaves as they are."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree


def smoke_overrides(arch_id: str) -> dict:
    """Every field of the arch's SMOKE config, as ``build`` overrides."""
    import dataclasses
    import importlib

    mod = {"gemma3-1b": "gemma3_1b", "dlrm-mlperf": "dlrm_mlperf",
           "graphsage-reddit": "graphsage_reddit"}[arch_id]
    smoke = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    return {f.name: getattr(smoke, f.name)
            for f in dataclasses.fields(smoke) if f.name != "name"}


def count_card_and_cpu(dev, arch_id: str, shape: str, cut: dict,
                       seed: int) -> dict:
    """Phase 21: one SMOKE cell's step counted on the card and on the CPU
    from the same inputs (made on the CPU): FLOPs (and by class),
    transcendentals, bytes, collectives and each kernel's units,
    operations and bytes must be equal, and on the
    card each kernel's units its launches.  Returns the card's launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.analysis import count
    from repro_torch.configs import registry

    built = registry.get(arch_id).build(shape, {**smoke_overrides(arch_id),
                                                **cut})
    inputs = built.make_inputs("cpu", seed)
    card_inputs = to_device(inputs, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, card = count.measure(built.fn, card_inputs, dev)
    launches = {k: v for k, v in launch_counts().items() if v}
    _, cpu = count.measure(built.fn, inputs, "cpu")
    keys = ("flops", "transcendentals", "flops_by_class", "bytes",
            "collectives", "kernels")
    label = f"{arch_id} × {shape} SMOKE {cut or ''}".strip()
    if any(card[k] != cpu[k] for k in keys):
        diff = {op: (card["by_op"].get(op), cpu["by_op"].get(op))
                for op in set(card["by_op"]) | set(cpu["by_op"])
                if card["by_op"].get(op) != cpu["by_op"].get(op)}
        fail(f"dryrun: {label}: the card's count != the CPU's: "
             f"{ {k: (card[k], cpu[k]) for k in keys} }; ops "
             f"[calls, flops, bytes] (card, cpu) that differ: {diff}")
    units = {k: v["units"] for k, v in card["kernels"].items()}
    if units != launches:
        fail(f"dryrun: {label}: counted units {units} != launches "
             f"{launches} on the card")
    phase("dryrun", f"{label}: card == CPU: flops {card['flops']} bytes "
                    f"{card['bytes']} kernels {card['kernels']} (card "
                    f"launches {launches}); host<->card transfer bytes "
                    f"{card['transfer_bytes']} on the card, "
                    f"{cpu['transfer_bytes']} on the CPU; run_s card "
                    f"{card['run_s']:.3f} cpu {cpu['run_s']:.3f}")
    return launches


def count_card_and_meta(dev, arch_id: str, shape: str, ov: dict,
                        seed: int, label: str) -> tuple:
    """Phase 21: a cell counted on meta (``configs.base``'s abstract
    inputs) and on the card (the same index arrays, drawn on the host and
    moved there): FLOPs (and by class), transcendentals, bytes, transfer
    bytes, collectives and each kernel's units, operations and bytes must
    be equal, and on the card each kernel's units its launches.  Returns
    (the card's launches, the
    meta temp bytes' gap to the card's peak, relative)."""
    import torch

    from repro_torch.analysis import count
    from repro_torch.configs import registry

    built = registry.get(arch_id).build(shape, ov)
    _, meta = count.measure(built.fn, built.make_inputs("meta", seed),
                            "meta")
    inputs = built.make_inputs(dev, seed)
    torch.cuda.synchronize()
    before = launch_counts()
    out, card = count.measure(built.fn, inputs, dev, tally=True)
    del inputs, out
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v - before[k]}
    keys = ("flops", "transcendentals", "flops_by_class", "bytes",
            "transfer_bytes", "collectives", "kernels")
    if any(card[k] != meta[k] for k in keys):
        diff = {op: (card["by_op"].get(op), meta["by_op"].get(op))
                for op in set(card["by_op"]) | set(meta["by_op"])
                if card["by_op"].get(op) != meta["by_op"].get(op)}
        fail(f"dryrun: {label}: the meta count != the card's: "
             f"{ {k: (meta[k], card[k]) for k in keys} }; ops "
             f"[calls, flops, bytes] (card, meta) that differ: {diff}")
    units = {k: v["units"] for k, v in card["kernels"].items()}
    if units != launches:
        fail(f"dryrun: {label}: counted units {units} != launches "
             f"{launches} on the card")
    mem, cm = meta["memory"], card["memory"]
    gap = (mem["temp_bytes"] - cm["temp_bytes"]) / max(cm["temp_bytes"], 1)
    phase("dryrun", f"{label}: meta == card: flops {meta['flops']} bytes "
                    f"{meta['bytes']} transfer bytes "
                    f"{meta['transfer_bytes']} kernels {meta['kernels']} "
                    f"(card launches {launches}); temp bytes: meta "
                    f"{mem['temp_bytes']}, card peak {cm['temp_bytes']} "
                    f"(its storage tally {cm['tally_temp_bytes']}), gap "
                    f"{gap:+.4f}; argument bytes meta "
                    f"{mem['argument_bytes']} card {cm['argument_bytes']}; "
                    f"meta host_s {meta['host_s']:.3f}, card run_s "
                    f"{card['run_s']:.3f}")
    torch.cuda.empty_cache()
    return launches, gap


def abstract_phase(dev, opts) -> dict:
    """Phase 21's abstract half: the SMOKE cells and the ``DRYRUN_META``
    probe points counted on meta against the card (``count_card_and_meta``),
    the largest temp-bytes gap (reported, not gated), and the
    ``DRYRUN_META_ONLY`` cells on meta alone.  Returns the card's
    launches."""
    from repro_torch.analysis import count
    from repro_torch.configs import registry

    launched, gaps = {}, {}
    points = [(a, s, {**smoke_overrides(a), **cut}, f"{a} × {s} SMOKE "
               f"{cut or ''}".strip()) for a, s, cut in DRYRUN_SMOKE]
    points += [(a, s, ov, f"{a} × {s} {ov or 'full'}")
               for a, s, ov in DRYRUN_META]
    for arch_id, shape, ov, label in points:
        got, gaps[label] = count_card_and_meta(dev, arch_id, shape, ov,
                                               opts.seed, label)
        for k, v in got.items():
            launched[k] = launched.get(k, 0) + v
    worst = max(gaps, key=lambda k: abs(gaps[k]))
    phase("dryrun", f"meta temp bytes against the card's peak: largest "
                    f"relative gap {gaps[worst]:+.4f} at {worst}")
    for arch_id, shape, ov in DRYRUN_META_ONLY:
        built = registry.get(arch_id).build(shape, ov)
        t0 = time.time()
        _, rec = count.measure(built.fn, built.make_inputs("meta",
                                                           opts.seed),
                               "meta")
        phase("dryrun", f"{arch_id} × {shape} {ov} on meta (fits no "
                        f"card): flops {rec['flops']} transcendentals "
                        f"{rec['transcendentals']} (by class "
                        f"{rec['flops_by_class']}) bytes {rec['bytes']} "
                        f"transfer bytes {rec['transfer_bytes']} kernels "
                        f"{rec['kernels']} temp bytes "
                        f"{rec['memory']['temp_bytes']} argument bytes "
                        f"{rec['memory']['argument_bytes']}; host_s "
                        f"{rec['host_s']:.1f} (inputs and count "
                        f"{time.time() - t0:.1f} s)")
        if (arch_id, shape) == STACKED_CELL:
            stacked_gradient_bytes(built, rec, opts.seed,
                                   f"{arch_id} × {shape} {ov}")
    return launched


def sharded_phase(opts) -> None:
    """Phase 21: each ``DRYRUN_SHARDED`` cell counted as a sharded program
    on its production mesh by the dry-run's default route, beside the
    same mesh's even split of the unsharded count: per-device argument
    bytes, collective bytes and calls by kind, t_collective_s, the
    bottleneck and host_s.  No card is used; a failed sharded count fails
    the run."""
    from repro_torch.launch import dryrun

    info = dryrun.device_info("meta")
    for arch_id, shape, ov, mesh in DRYRUN_SHARDED:
        t0 = time.time()
        before = launch_counts()
        cell = dryrun.run_cell(arch_id, shape, overrides=ov, seed=opts.seed,
                               sharded=(mesh,))
        got = {k: v - before[k] for k, v in launch_counts().items()
               if v - before[k]}
        sharded = cell["sharded"][mesh]
        if "error" in sharded or got:
            fail(f"dryrun: {arch_id} × {shape} {ov} sharded on {mesh}: "
                 f"launches {got}; {sharded.get('error', '')}")
        rec = dryrun.mesh_record(arch_id, shape, mesh, cell, cell["total"],
                                 info, ov)
        even = dryrun.mesh_record(arch_id, shape, mesh,
                                  {k: v for k, v in cell.items()
                                   if k != "sharded"}, cell["total"], info,
                                  ov)
        if not (rec["sharded"] and rec["collectives"]
                and rec["roofline"]["t_collective_s"] > 0):
            fail(f"dryrun: {arch_id} × {shape} {ov} on {mesh}: a sharded "
                 f"record without collectives: {rec}")
        rf, erf = rec["roofline"], even["roofline"]
        phase("dryrun", f"{arch_id} × {shape} {ov or 'full'} sharded on "
                        f"{mesh} ({rec['n_chips']} ranks, counted on rank "
                        f"0): argument bytes/dev "
                        f"{rec['memory']['argument_bytes']} (even split "
                        f"{even['memory']['argument_bytes']:.6e}); "
                        f"collectives {rec['collectives']} (calls "
                        f"{rec['collective_calls']}); t_collective_s "
                        f"{rf['t_collective_s']:.6e} (even split "
                        f"{erf['t_collective_s']:.6e}); bottleneck "
                        f"{rf['bottleneck']} (even split "
                        f"{erf['bottleneck']}); "
                        f"{dryrun.summary_line(rec)}; host_s "
                        f"{rec['host_s']:.3f} (cell {time.time() - t0:.1f}"
                        f" s)")


def indexed_layer_slices(stacked: dict) -> list:
    """Layer i's weights indexed from each stacked ``[L, ...]`` weight,
    ``p[i]``: the slicing ``models.common.layer_slices`` replaced (each
    layer's backward a ``select_backward`` writing a whole ``[L, ...]``
    gradient)."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def stacked_gradient_bytes(built, rec: dict, seed: int, label: str) -> None:
    """Phase 21: a training cell's meta count (``rec``, its stacked
    weights cut once a forward by ``torch.unbind``) against the same count
    with each layer's weights indexed from the stack: the bytes of both,
    the ``select_backward`` bytes, and what ``unbind``'s backward (a
    ``stack``) moves instead.  With the layers cut once there must be no
    ``select_backward`` left, fewer bytes, and no more FLOPs (the indexed
    gradients' sum adds L [L, ...] tensors: O(L^2) FLOPs too)."""
    from repro_torch.analysis import count
    from repro_torch.models import common as MC

    slices = MC.layer_slices
    MC.layer_slices = indexed_layer_slices
    try:
        _, idx = count.measure(built.fn, built.make_inputs("meta", seed),
                               "meta")
    finally:
        MC.layer_slices = slices

    def op_bytes(r, name):
        return r["by_op"].get(f"aten.{name}.default", [0, 0, 0])[2]

    sel, sel_idx = (op_bytes(r, "select_backward") for r in (rec, idx))
    if sel or not sel_idx or idx["flops"] < rec["flops"] \
            or rec["bytes"] >= idx["bytes"]:
        fail(f"dryrun: {label}: layer slices by unbind: bytes "
             f"{rec['bytes']}, select_backward {sel}; indexed: bytes "
             f"{idx['bytes']}, select_backward {sel_idx}; flops "
             f"{rec['flops']} / {idx['flops']}")
    phase("dryrun", f"{label} on meta, stacked weights' gradients: bytes "
                    f"{rec['bytes']} with the layers cut by unbind (stack "
                    f"{op_bytes(rec, 'stack')}, select_backward {sel}); "
                    f"{idx['bytes']} with each layer indexed "
                    f"(select_backward {sel_idx}, stack "
                    f"{op_bytes(idx, 'stack')}); saved "
                    f"{idx['bytes'] - rec['bytes']} bytes "
                    f"({(idx['bytes'] - rec['bytes']) / idx['bytes']:.4%}); "
                    f"flops {rec['flops']} against {idx['flops']} indexed "
                    f"(add.Tensor, which sums the indexed gradients: "
                    f"{idx['by_op'].get('aten.add.Tensor', [0, 0])[1]} "
                    f"against {rec['by_op'].get('aten.add.Tensor', [0, 0])[1]}"
                    f")")


def compression_card_and_cpu(dev, seed: int) -> None:
    """Phase 21: ``compress_int8_ef`` (float32 and bfloat16 leaves) and
    ``topk_ef`` (float32 leaves: bfloat16 magnitudes tie) on CUDA tensors,
    three error-feedback steps, bit for bit with the same calls on the
    CPU; then
    ``hierarchical_psum`` on 4 gloo ranks (2 pods x 2 data) on cuda:0
    against a flat ``all_reduce``: exact on integer-valued float32, within
    float32 rounding (1e-6 of the sum of |x|) on normal data."""
    import numpy as np
    import torch

    from repro_torch.distributed import compression as C
    from repro_torch.launch import mesh
    from repro_torch.train.optimizer import leaves

    rng = np.random.default_rng(seed)
    g_cpu = {"w": torch.from_numpy(rng.normal(size=(257, 33)).astype(
                 np.float32)),
             "b": torch.from_numpy(rng.normal(size=(129,)).astype(
                 np.float32)).to(torch.bfloat16),
             "n": {"x": torch.from_numpy(rng.normal(size=(5, 3)).astype(
                 np.float32))}}
    g_card = to_device(g_cpu, dev)

    def bits(tree):
        return [t.cpu().view(torch.int8 if t.dtype == torch.int8 else
                             torch.int32 if t.element_size() == 4 else
                             torch.int16) for t in leaves(tree)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))

    for name, step in (("compress_int8_ef", C.compress_int8_ef),
                       ("topk_ef", lambda g, ef: C.topk_ef(g, ef, 0.05))):
        if name == "topk_ef":
            # float32 leaves only: bfloat16 magnitudes tie, and the two
            # devices' top-k may order ties differently
            g_cpu = {k: v for k, v in g_cpu.items() if k != "b"}
            g_card = to_device(g_cpu, dev)
        ef_cpu, ef_card = C.ef_init(g_cpu), C.ef_init(g_card)
        for i in range(3):
            *out_cpu, ef_cpu = step(g_cpu, ef_cpu)
            *out_card, ef_card = step(g_card, ef_card)
            if not (same(out_card, out_cpu)
                    and same(ef_card.residual, ef_cpu.residual)):
                fail(f"dryrun: {name} step {i} on the card != the CPU")
        phase("dryrun", f"{name}: 3 error-feedback steps on {dev} == the "
                        f"CPU, bit for bit (outputs and residuals)")
    xs = [rng.integers(-1000, 1000, (4, 37, 5)).astype(np.float32),
          rng.normal(size=(4, 1000, 3)).astype(np.float32)]
    outs = mesh.spawn_pes(C.psum_rank, 4, args=([(2, 2)], xs),
                          backend="gloo", device=dev.type)
    where = {str(mesh.pe_device(0, dev.type))}
    for x, o in zip(xs, outs):
        err = float(np.abs(o["hier"] - o["flat"]).max())
        tol = 0.0 if x is xs[0] else 1e-6 * float(np.abs(x).sum(0).max())
        if err > tol or set(o["device"]) != where:
            fail(f"dryrun: hierarchical_psum != flat all_reduce ({err}, "
                 f"devices {set(o['device'])})")
        phase("dryrun", f"hierarchical_psum {x.shape[1:]} on 4 gloo ranks "
                        f"(2 pods x 2 data) on {where}: max |hier - flat| = "
                        f"{err} (tolerance {tol}); counted collectives of a "
                        f"rank {o['coll'][0]}")


def dryrun_phase(dev, opts, probe: dict) -> None:
    """Phase 21 (the dry-run, ``launch/dryrun.py``): the SMOKE cells of
    ``DRYRUN_SMOKE`` counted card against CPU; the two ``DRYRUN_FULL``
    cells at full size by the dry-run's default route (on meta: no
    launch, no ``superseded_by``), each record's flops, transcendentals,
    bytes, t_bound, bottleneck, host_s and roofline fraction on the
    ``card`` mesh; ``DRYRUN_CARD_ROUTE`` by the card probe route against
    its meta record; the MWIS sweep-round probe's record from phase 17's
    ranks; the abstract count held to the card and the stacked weights'
    gradient bytes (``abstract_phase``); the compression checks.  Every
    kernel of the dry-run's cells must have launched."""
    import torch

    from repro_torch.launch import dryrun

    t_phase = time.time()
    torch.cuda.empty_cache()
    launched = dict(segment_fused=probe["kernels"]["segment_fused"]["units"])
    for arch_id, shape, cut in DRYRUN_SMOKE:
        for k, v in count_card_and_cpu(dev, arch_id, shape, cut,
                                       opts.seed).items():
            launched[k] = launched.get(k, 0) + v
    info = dryrun.device_info(dev)
    metas = {}
    for arch_id, shape in DRYRUN_FULL:
        # the dry-run's default route: the cell on meta at its full shape
        before = launch_counts()
        cell = dryrun.run_cell(arch_id, shape, dev, seed=opts.seed,
                               sharded=())
        rec = dryrun.mesh_record(arch_id, shape, "card", cell, cell["total"],
                                 dryrun.device_info("meta"))
        got = {k: v - before[k] for k, v in launch_counts().items()
               if v - before[k]}
        if (rec["counted_on"] != "meta" or "superseded_by" in rec
                or got):
            fail(f"dryrun: {arch_id} × {shape}: the default route gave a "
                 f"record counted on {rec['counted_on']} "
                 f"(superseded_by {rec.get('superseded_by')}), launches "
                 f"{got}")
        top = cell["probes"][0]["top_ops"]
        phase("dryrun", f"{arch_id} × {shape} (default route, counted on "
                        f"meta; card mesh): {dryrun.summary_line(rec)}; "
                        f"flops by class {rec['flops_by_class']}; probes "
                        f"{[(p['tag'], round(p['host_s'], 3))
                            for p in cell['probes']]}"
                        f"; kernels {rec['kernels']}; memory {rec['memory']}; "
                        f"model_flops {cell['model_flops']:.6e}; top ops of "
                        f"probe {cell['probes'][0]['tag']} [calls, flops, "
                        f"bytes, transcendentals]: "
                        f"{dict(list(top.items())[:6])}"
                        f"; note: {rec['note']}")
        metas[arch_id, shape] = rec
    # the card probe route (``--probes``), until a later PR retires it
    arch_id, shape = DRYRUN_CARD_ROUTE
    torch.cuda.synchronize()
    before = launch_counts()
    cell = dryrun.run_cell(arch_id, shape, dev, seed=opts.seed,
                           abstract=False)
    rec = dryrun.mesh_record(arch_id, shape, "card", cell, cell["total"],
                             info)
    got = {k: v - before[k] for k, v in launch_counts().items()
           if v - before[k]}
    units = {k: sum(p["kernels"].get(k, {}).get("units", 0)
                    for p in cell["probes"]) for k in got}
    if (cell["counted_on"] != dev.type or not got or units != got
            or rec.get("superseded_by") != "abstract"):
        fail(f"dryrun: {arch_id} × {shape} by the card probe route: counted "
             f"on {cell['counted_on']}, units {units}, launches {got}")
    for k, v in got.items():
        launched[k] = launched.get(k, 0) + v
    meta = metas[arch_id, shape]
    phase("dryrun", f"{arch_id} × {shape} (the card probe route, --probes; "
                    f"{info.get('nvidia_smi', dev.type)}): "
                    f"{dryrun.summary_line(rec)}; probes "
                    f"{[(p['tag'], round(p['run_s'], 3))
                        for p in cell['probes']]}; kernels {rec['kernels']}; "
                    f"launches {got}"
                    + "; card route / meta: " + ", ".join(
                        f"{k} {rec['cost'][k] / meta['cost'][k]:.4f}"
                        for k in ("flops", "bytes_accessed")))
    torch.cuda.empty_cache()
    cell = dict(family="mwis", pes=probe["pes"],
                probes=[dict(tag="sweep", point={}, run_s=probe["run_s"])],
                model_flops=10.0 * probe["pes"] * probe["shape"]["E"],
                full_point={}, note=(
                    f"algo=sweep-round p={probe['pes']} {probe['cfg']} "
                    f"(phase 17's gloo ranks on cuda:0); per-PE shape "
                    + ", ".join(f"{k} {v}" for k, v in
                                probe["shape"].items())))
    rec = dryrun.mesh_record("mwis", "strong_128m", "card", cell, probe,
                             info)
    phase("dryrun", f"mwis × sweep-round probe at strong_128m's per-PE "
                    f"shape (card): {dryrun.summary_line(rec)}; collectives "
                    f"{rec['collectives']}; kernels {rec['kernels']}")
    t_abstract = time.time()
    for k, v in abstract_phase(dev, opts).items():
        launched[k] = launched.get(k, 0) + v
    phase("dryrun", f"abstract count against the card: "
                    f"{time.time() - t_abstract:.1f} s")
    sharded_phase(opts)
    compression_card_and_cpu(dev, opts.seed)
    missing = [k for k in ("segment_fused", "segment_sum", "embedding_bag",
                           "embedding_bag_backward") if not launched.get(k)]
    if missing:
        fail(f"dryrun: the dry-run's cells never launched {missing}")
    phase("dryrun", f"kernel launches of the dry-run's counted runs "
                    f"(phase 17's probe included): {launched}; phase "
                    f"seconds={time.time() - t_phase:.1f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="RGG vertices of the main-path instance")
    ap.add_argument("--rnp-n", type=int, default=1 << 15,
                    help="RGG vertices of the reduce-and-peel run")
    ap.add_argument("--dist-rnp-n", type=int, default=1 << 10,
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
    if set(libs) != set(REPLACES) - set(SHARED_LIBRARY):
        fail(f"kernel libraries {sorted(libs)} != the four of REPLACES")
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
    uprob, ucfg = reduce_problem(base, pg)
    profile_reduce(uprob, ucfg)
    torch.cuda.empty_cache()
    sfull = segment_sum_at_size(dev, opts.seed, opts.reps)
    efull = embedding_bag_at_size(dev, opts.seed, opts.reps)
    sk = serve_phase(opts)
    staged = descent_phase(base, g, pg, rg_members, rg_seconds)
    dk = resume_phase(base, g, pg, staged, opts.reps)
    dk["launches"] = staged["launches"]
    xk = dist_phase(base, g, pg, red_snap, rg_snap, uprob, opts)
    del uprob
    efull["launches"] += models_phase(dev, opts)
    train_phase(dev, opts)
    ta = train_archs_phase(dev, opts)
    dryrun_phase(dev, opts, xk.pop("sweep_probe"))
    efull["launches"] += ta["launches"].get("embedding_bag", 0)
    sfull["launches"] += ta["launches"].get("segment_sum", 0)
    bwd = efull.pop("backward")
    bwd.update(launches=ta["launches"]["embedding_bag_backward"],
               max_abs_err=max(bwd["max_abs_err"], ta["bwd_err"]))

    kfull.update(launches=launches,
                 max_abs_err=max(err, kfull["max_abs_err"]))
    for name, full in (("segment_sum", sfull), ("wedge_intersect", wfull),
                       ("embedding_bag", efull)):
        full["launches"] += rec[name]["launches"]
        full["max_abs_err"] = max(full["max_abs_err"],
                                  rec[name]["max_abs_err"])
    found = dict(segment_fused=kfull, segment_sum=sfull,
                 wedge_intersect=wfull, embedding_bag=efull,
                 embedding_bag_backward=bwd)
    rows = [dict(
        name=name, route="cuda",
        source=str(libs[SHARED_LIBRARY.get(name, name)][1][0]
                   .relative_to(ROOT)),
        replaces=REPLACES[name],
        **{key: found[name][key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms",
            *(FUSED_EXTRA if name == "segment_fused" else ()))},
    ) for name in REPLACES]
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
