"""The hand-written CUDA kernels on the card: each held against its plain
torch version (the int32 kernels exactly, the float ones at the tolerance
stated beside them), the ``cuda`` backend's solve against the CPU run, and
the models: DLRM through the ``embedding_bag`` kernel against its plain
lookup (bit for bit), LM decode against the CPU run, and DLRM's and the
GNNs' training steps (the ``embedding_bag`` backward kernel, the
``segment_sum`` kernel) against the CPU run.

Needs a CUDA card (marker ``gpu``); skips on a CPU-only machine.  On the
card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import dlrm_mlperf, gemma3_1b
from repro_torch.core import distributed as D
from repro_torch.core import engine as E
from repro_torch.core import serve as SV
from repro_torch.core import partition as part
from repro_torch.core import solvers as S
from repro_torch.graphs import generators as gen
from repro_torch.kernels.embedding_bag import kernel as EK
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_bwd_ref, embedding_bag_ref,
)
from repro_torch.kernels.segment_coo import kernel as K
from repro_torch.kernels.segment_coo.ops import (
    pack_blocks, segment_fused_coo, segment_fused_plain, segment_sum_coo,
    segment_sum_plain,
)
from repro_torch.kernels.wedge_intersect import kernel as WK
from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
from repro_torch.kernels.wedge_intersect.ref import common_neighbor_stats_ref
from repro_torch.data.pipeline import DLRMBatchSpec, dlrm_batch
from repro_torch.launch import mesh
from repro_torch.models import common as MC
from repro_torch.models import dlrm as DM
from repro_torch.models import transformer as TM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n_rows,n_edges,r_blk,widths,nbits", [
    (17, 120, 8, (2, 2, 1, 0), 16),
    (64, 9, 8, (2, 2, 1, 0), 16),
    (23, 77, 8, (0, 3, 0, 0), 16),
    (17, 120, 8, (1, 0, 0, 2), 12),
    (64, 9, 8, (0, 0, 0, 2), 5),
    (40, 300, 64, (2, 2, 0, 2), 8),
    (5000, 40000, 64, (2, 2, 1, 2), 16),
])
def test_kernel_matches_plain(cuda, n_rows, n_edges, r_blk, widths, nbits):
    rng = np.random.default_rng(0)
    row = np.sort(rng.integers(0, n_rows, size=n_edges)).astype(np.int32)
    perm, lrow, _ = pack_blocks(row, n_rows, r_blk=r_blk, e_blk_multiple=8)
    names = ("data_sum", "data_max", "data_min", "data_or")
    data = {
        k: torch.from_numpy(
            rng.integers(-(1 << 20), 1 << 20, size=(n_edges, d))
            .astype(np.int32)).to(cuda)
        for k, d in zip(names, widths) if d
    }
    perm = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    lrow = torch.from_numpy(lrow).to(cuda)
    before = kernels.launch_count("segment_fused")
    got = segment_fused_coo(perm, lrow, n_rows, r_blk=r_blk, or_nbits=nbits,
                            **data)
    torch.cuda.synchronize()
    assert kernels.launch_count("segment_fused") == before + 1
    want = segment_fused_plain(perm, lrow, n_rows, r_blk=r_blk,
                               or_nbits=nbits, **data)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def _stacked_case(rng, n_rows, n_edges, r_blk, batch, widths, device):
    """``batch`` random instances of one shape — rows sorted, a quarter of
    the slots on the last (nil) row as a partition pads them — packed,
    stacked (``engine.stack_plans``) and with [batch*E, D*] payloads."""
    plans = []
    for _ in range(batch):
        row = rng.integers(0, n_rows, size=n_edges)
        row[: n_edges // 4] = n_rows - 1
        plans.append(E.build_plan(np.sort(row).astype(np.int32), n_rows,
                                  r_blk=r_blk, device=device))
    names = ("data_sum", "data_max", "data_min", "data_or")
    data = {
        k: torch.from_numpy(
            rng.integers(-(1 << 20), 1 << 20, size=(batch * n_edges, d))
            .astype(np.int32)).to(device)
        for k, d in zip(names, widths) if d
    }
    return E.stack_plans(plans), plans, data


#: The serve cells' rows (V = L + G + 1), edge slots and r_blk.
SERVE_SHAPES = [(69, 1024, 8), (261, 4096, 16), (1029, 16384, 32)]


@pytest.mark.parametrize("batch", [1, 4, 64])
@pytest.mark.parametrize("n_rows,n_edges,r_blk", SERVE_SHAPES)
def test_batched_kernel_matches_plain(cuda, n_rows, n_edges, r_blk, batch):
    """The kernel over a stacked plan (one grid row per instance) against
    the batched plain version: exact."""
    rng = np.random.default_rng(batch * 31 + r_blk)
    plan, _, data = _stacked_case(rng, n_rows, n_edges, r_blk, batch,
                                  (2, 2, 1, 2), cuda)
    before = kernels.launch_count("segment_fused")
    got = segment_fused_coo(plan.edge_perm, plan.lrow, n_rows, r_blk=r_blk,
                            or_nbits=8, **data)
    torch.cuda.synchronize()
    assert kernels.launch_count("segment_fused") == before + 1
    want = segment_fused_plain(plan.edge_perm, plan.lrow, n_rows,
                               r_blk=r_blk, or_nbits=8, **data)
    for g, w in zip(got, want):
        assert g.shape == (batch * n_rows, w.shape[1])
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_rows,n_edges,r_blk", SERVE_SHAPES)
def test_batch_of_one_is_the_unbatched_launch(cuda, n_rows, n_edges, r_blk):
    """A stacked plan of one instance gives the 2-D plan's launch bit for
    bit; each instance of a batch of 4 gives its own unbatched result."""
    rng = np.random.default_rng(r_blk)
    for batch in (1, 4):
        plan, plans, data = _stacked_case(rng, n_rows, n_edges, r_blk,
                                          batch, (2, 2, 0, 2), cuda)
        got = K.segment_fused(plan.edge_perm, plan.lrow, n_rows,
                              r_blk=r_blk, or_nbits=8, **data)
        for b, one in enumerate(plans):
            mine = {k: v[b * n_edges:(b + 1) * n_edges]
                    for k, v in data.items()}
            want = K.segment_fused(one.edge_perm, one.lrow, n_rows,
                                   r_blk=r_blk, or_nbits=8, **mine)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if w is not None:
                    assert torch.equal(g[b * n_rows:(b + 1) * n_rows], w)


def _assert_exact(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def _int_payloads(rng, n_edges, widths, device):
    """Random int32 payload groups (OR payloads carry every bit, so the
    or_nbits mask is exercised)."""
    names = ("data_sum", "data_max", "data_min", "data_or")
    return {
        k: torch.from_numpy(
            rng.integers(-(1 << 31), 1 << 31, size=(n_edges, d))
            .astype(np.int32)).to(device)
        for k, d in zip(names, widths) if d
    }


def _fused_both_ways(plan, n_rows, data, or_nbits=16):
    """The kernel with the plan's extent and with the one its wrapper
    derives, each exact against the plain version."""
    kw = dict(r_blk=plan.r_blk, or_nbits=or_nbits, **data)
    want = segment_fused_plain(plan.edge_perm, plan.lrow, n_rows, **kw)
    for extent in (plan.extent, None):
        before = kernels.launch_count("segment_fused")
        got = segment_fused_coo(plan.edge_perm, plan.lrow, n_rows,
                                extent=extent, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_count("segment_fused") == before + 1
        _assert_exact(got, want)


@pytest.mark.parametrize("batch", [0, 1, 8])
@pytest.mark.parametrize("n_rows,n_edges,r_blk",
                         SERVE_SHAPES + [(4000, 60000, 64)])
def test_kernel_on_a_nil_heavy_plan(cuda, n_rows, n_edges, r_blk, batch):
    """80 % of each instance's edges on its last row, as a partition puts
    its padding edges on the nil row: that row block holds up to 48,000
    slots of one row (serve_m: 13,107), folded within warps and split over
    thread blocks.  Unbatched (batch 0) and stacked, exact."""
    rng = np.random.default_rng(7 * batch + r_blk)
    plans = []
    for _ in range(max(batch, 1)):
        row = rng.integers(0, n_rows, size=n_edges)
        row[: n_edges * 4 // 5] = n_rows - 1
        plans.append(E.build_plan(np.sort(row).astype(np.int32), n_rows,
                                  r_blk=r_blk, device=cuda))
    plan = E.stack_plans(plans) if batch else plans[0]
    data = _int_payloads(rng, max(batch, 1) * n_edges, (2, 2, 1, 2), cuda)
    _fused_both_ways(plan, n_rows, data, or_nbits=16)


def _hand_plan(rng, n_rows, r_blk, e_blk, device):
    """A plan built by hand: live slots of any row in any order, padding
    (r_blk, negative, above r_blk) among and after them, a block with no
    live slot, and every slot's edge id random."""
    n_blocks = -(-n_rows // r_blk)
    lrow = rng.integers(0, r_blk, size=(n_blocks, e_blk)).astype(np.int32)
    pad = rng.random((n_blocks, e_blk)) < 0.3
    lrow[pad] = rng.choice(np.array([r_blk, -1, r_blk + 5], np.int32),
                           size=int(pad.sum()))
    lrow[0, e_blk // 2:] = r_blk
    lrow[1] = -1
    lrow[-1][lrow[-1] >= n_rows - (n_blocks - 1) * r_blk] = r_blk
    n_edges = 3 * e_blk
    perm = rng.integers(0, n_edges, size=(n_blocks, e_blk)).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    lrow = t(lrow)
    return E.SegPlan(edge_perm=t(perm), lrow=lrow, r_blk=r_blk,
                     extent=E.live_extent(lrow, r_blk)), n_edges


@pytest.mark.parametrize("e_blk", [40, 5000, 20000])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_skips_padding_inside_blocks(cuda, e_blk, seed):
    """Padding inside a block's extent is skipped by its local row; the
    extent is one past the last live slot, not a count of live slots."""
    rng = np.random.default_rng(seed)
    plan, n_edges = _hand_plan(rng, 45, 8, e_blk, cuda)
    live = ((plan.lrow >= 0) & (plan.lrow < 8)).sum(1)
    assert bool((plan.extent > live).any())
    _fused_both_ways(plan, 45, _int_payloads(rng, n_edges, (2, 2, 1, 2),
                                             cuda))


@pytest.mark.parametrize("run", [1000, 3001, 4096, 4097])
def test_kernel_rows_across_chunk_boundaries(cuda, run):
    """One row block of 20,000 live slots in runs of ``run`` slots cycling
    over rows 0..3 (so a row recurs in runs that are not neighbours, and
    runs straddle every 1,024 / 2,048 / 4,096-slot boundary), beside a
    block of ordinary rows; unbatched and a batch of 3."""
    rng = np.random.default_rng(run)
    r_blk, e_blk = 4, 20000
    heavy = (np.arange(e_blk) // run % r_blk).astype(np.int32)
    light = np.full(e_blk, r_blk, dtype=np.int32)
    light[:50] = np.sort(rng.integers(0, r_blk, size=50))
    for batch in (0, 3):
        lrow = np.stack([heavy, light])
        perm = rng.permutation(2 * e_blk)[:2 * e_blk].reshape(2, e_blk)
        if batch:
            lrow = np.stack([lrow] * batch)
            perm = np.stack([perm] * batch)
        lrow_t = torch.from_numpy(lrow).to(cuda)
        plan = E.SegPlan(
            edge_perm=torch.from_numpy(perm.astype(np.int32)).to(cuda),
            lrow=lrow_t, r_blk=r_blk, extent=E.live_extent(lrow_t, r_blk))
        data = _int_payloads(rng, max(batch, 1) * 2 * e_blk, (2, 1, 1, 1),
                             cuda)
        _fused_both_ways(plan, 2 * r_blk, data)


@pytest.mark.parametrize("widths", [(2, 2, 2, 2), (3, 1, 2, 5),
                                    (0, 0, 0, 1)])
@pytest.mark.parametrize("or_nbits", [1, 16, 31])
def test_kernel_all_groups_and_or_widths(cuda, widths, or_nbits):
    """Every payload group, widths past the columns a lane loads at once,
    and OR payloads cut to 1, 16 and 31 bits, on a nil-heavy serve_m plan
    (the heavy block split): exact."""
    rng = np.random.default_rng(or_nbits)
    n_rows, n_edges, r_blk = 1029, 16384, 32
    row = rng.integers(0, n_rows, size=n_edges)
    row[: n_edges * 4 // 5] = n_rows - 1
    plan = E.build_plan(np.sort(row).astype(np.int32), n_rows, r_blk=r_blk,
                        device=cuda)
    _fused_both_ways(plan, n_rows, _int_payloads(rng, n_edges, widths, cuda),
                     or_nbits=or_nbits)


@pytest.mark.parametrize("algo", ["rg", "rnp"])
def test_batched_serving_on_cuda_matches_torch(cuda, algo):
    """The serving path on the card (stacked plans, the kernel's batch axis)
    against the service's ``torch`` backend on the card: every request's
    members and weight identical, through all three cells."""
    from repro_torch.launch.serve import make_requests

    reqs = make_requests(SV.serve_cells(), 12 if algo == "rg" else 6, 2, 0)
    before = kernels.launch_count("segment_fused")
    got = SV.MWISService(SV.ServeConfig(
        algo=algo, backend="cuda", max_batch=16, verify="full",
    )).solve_batch(reqs)
    assert kernels.launch_count("segment_fused") > before
    want = SV.MWISService(SV.ServeConfig(
        algo=algo, backend="torch", max_batch=16,
    )).solve_batch(reqs)
    for g, w in zip(got, want):
        assert g.ok and w.ok and g.weight == w.weight
        np.testing.assert_array_equal(g.members, w.members)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ok and w.ok and g.weight == w.weight
        np.testing.assert_array_equal(g.members, w.members)


def test_pipeline_on_cuda_matches_off(cuda):
    """The chunk pipeline on the card (copy and solve streams, pinned
    weight planes, a worker thread) against the synchronous service: every
    request identical, every chunk pipelined, the kernel launched."""
    from repro_torch.launch.serve import make_requests

    reqs = make_requests(SV.serve_cells(), 24, 2, 0)
    on = SV.MWISService(SV.ServeConfig(backend="cuda", max_batch=4,
                                       verify="full"))
    before = kernels.launch_count("segment_fused")
    got = on.solve_batch(reqs)
    assert kernels.launch_count("segment_fused") > before
    off = SV.MWISService(SV.ServeConfig(backend="cuda", max_batch=4,
                                        pipeline=False))
    _same_results(got, off.solve_batch(reqs))
    st = on.stats
    assert st["pipelined_chunks"] == st["chunks"] == 6
    assert st["pipeline_retries"] == 0 and st["fallbacks"] == 0
    on.close()
    off.close()


def test_pipeline_weight_planes_of_one_cell_in_turn(cuda):
    """Chunks of one cell and one topology with different weights, one
    request a chunk: each chunk's weight planes go through a pinned host
    block while the one before may still be copying, and every result
    comes back as the synchronous service's."""
    g = gen.gnm(200, 600, seed=4)
    rng = np.random.default_rng(4)
    reqs = [type(g)(indptr=g.indptr, indices=g.indices,
                    weights=rng.integers(1, 201, g.n).astype(np.int32))
            for _ in range(6)]
    on = SV.MWISService(SV.ServeConfig(backend="cuda", max_batch=1,
                                       verify="full"))
    got = on.solve_batch(reqs)
    off = SV.MWISService(SV.ServeConfig(backend="cuda", max_batch=1,
                                        pipeline=False))
    _same_results(got, off.solve_batch(reqs))
    assert len({r.weight for r in got}) > 1
    assert on.stats["pipelined_chunks"] == 6
    assert on.stats["cache_misses"] == 1
    on.close()
    off.close()


def test_pipeline_kernel_failure_in_a_worker(cuda, monkeypatch):
    """A ``segment_fused`` failure inside a worker thread ends as
    ``backend_failed`` on ``cuda``; no chunk runs the plain version."""
    from repro_torch.core import engine
    from repro_torch.core import validate as V
    from repro_torch.launch.serve import make_requests

    def broken(*a, **kw):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(engine, "segment_fused_coo", broken)
    svc = SV.MWISService(SV.ServeConfig(backend="cuda", max_batch=4))
    res = svc.solve_batch(make_requests(SV.serve_cells(), 8, 2, 0))
    assert all(not r.ok and r.reason == V.REASON_BACKEND_FAILED
               for r in res)
    st = svc.stats
    assert st["pipeline_retries"] == st["solve_errors"] == 3
    assert st["fallbacks"] == 0 and st["backend_active"] == "cuda"
    svc.close()


def test_two_shards_on_one_card(cuda, monkeypatch):
    """The sharded batch axis with both shards on the one card (the serve
    mesh's ``visible_devices`` seam): bit for bit with ``devices=1``."""
    from repro_torch.launch.serve import make_requests

    reqs = make_requests(SV.serve_cells(), 12, 2, 0)
    one = SV.MWISService(SV.ServeConfig(backend="cuda", max_batch=8,
                                        devices=1))
    want = one.solve_batch(reqs)
    monkeypatch.setattr(mesh, "visible_devices",
                        lambda kind: (torch.device("cuda", 0),) * 2)
    two = SV.MWISService(SV.ServeConfig(backend="cuda", max_batch=8))
    _same_results(two.solve_batch(reqs), want)
    assert two.stats["devices"] == 2
    assert {r["devices"] for r in two._stage_log} == {2}
    one.close()
    two.close()


def test_kernel_rejects_other_dtypes(cuda):
    perm = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    lrow = torch.full((1, 8), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        K.segment_fused(perm, lrow, 8, r_blk=8,
                        data_sum=torch.zeros((1, 1), device=cuda))


@pytest.mark.parametrize("algo,mode", [("reduce", "async"), ("rnp", "sync"),
                                       ("rg", "async")])
def test_cuda_solve_matches_cpu(cuda, algo, mode):
    """The whole union path on the card (kernel backend) == the CPU run of
    the port (plain version), bit for bit."""
    g = gen.rgg2d(3000, avg_deg=8, seed=4)
    pg = part.partition_graph(g, 4, window_cap=16)
    cfg = D.DisReduConfig(mode=mode, schedule="cheap-fused", backend="cuda")
    if algo == "reduce":
        gs, _, gr = D.disredu(pg, cfg, device=cuda)
        cs, _, cr = D.disredu(pg, cfg, device="cpu")
        assert gr == cr
    else:
        before = kernels.launch_count("segment_fused")
        gm, gs = S.solve(pg, algo, cfg, device=cuda)
        assert kernels.launch_count("segment_fused") > before
        cm, cs = S.solve(pg, algo, cfg, device="cpu")
        np.testing.assert_array_equal(gm, cm)
        assert g.is_independent_set(gm)
    for f in ("w", "status", "log_kind", "log_v", "log_u", "log_n",
              "offset"):
        assert torch.equal(getattr(gs, f).cpu(), getattr(cs, f)), f


def _dist_jobs(exchange):
    return [mesh.PEJob("reduce", D.DisReduConfig(
                mode="async", exchange=exchange, schedule="cheap-fused",
                backend="cuda")),
            mesh.PEJob("rg", D.DisReduConfig(
                mode="async", exchange=exchange, schedule="edges-only",
                backend="cuda"))]


@pytest.mark.parametrize("exchange", ["allgather", "a2a"])
def test_dist_on_cuda_matches_cpu(cuda, exchange, tmp_path):
    """The per-PE path, 4 gloo ranks on the card (kernel backend) == the
    same 4 ranks on the CPU (plain version), rank for rank, and each rank
    launched the kernel and no other."""
    g = gen.rgg2d(2000, avg_deg=8, seed=0)
    pg = part.partition_graph(g, 4, window_cap=16)
    jobs = _dist_jobs(exchange)
    on_gpu, _ = mesh.run_shard_map([pg], jobs, device="cuda",
                                directory=str(tmp_path))
    on_cpu, _ = mesh.run_shard_map([pg], jobs, device="cpu",
                                directory=str(tmp_path))
    for job, got, want in zip(jobs, on_gpu, on_cpu):
        for k in want:
            if k not in ("seconds", "load_seconds", "launches"):
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{job.algo}: {k}")
        assert (got["launches"]["segment_fused"] > 0).all(), job.algo
        assert all((got["launches"][k] == 0).all()
                   for k in kernels.KERNELS if k != "segment_fused")
    assert g.is_independent_set(D.members_global_per_pe(
        pg, on_gpu[1]["members"]))


def test_nccl_one_rank_matches_union(cuda, tmp_path):
    """NCCL at world size 1 (one card a rank): rg on the per-PE path ==
    the union solve at p = 1 on the card."""
    g = gen.rgg2d(2000, avg_deg=8, seed=1)
    pg = part.partition_graph(g, 1, window_cap=16)
    job = _dist_jobs("allgather")[1]
    (out,), _ = mesh.run_shard_map([pg], [job], backend="nccl", device="cuda",
                                directory=str(tmp_path))
    members, state = S.solve(pg, "rg", job.cfg, device=cuda)
    np.testing.assert_array_equal(
        D.members_global_per_pe(pg, out["members"]), members)
    np.testing.assert_array_equal(out["status"][0], state.status.cpu())


#: A two-rung ladder an RGG of 2,000 vertices on 2 PEs (L 1,005, E 7,936
#: a PE) descends through: rnp takes both rungs, rg the lower one.
TWO_RUNGS = (S.LadderCell("rung_s", 64, 1024, 32, 16, 16, r_blk=8),
             S.LadderCell("rung_m", 256, 4096, 64, 32, 32, r_blk=16))


def _staged_case():
    g = gen.rgg2d(2000, avg_deg=8, seed=0)
    pg = part.partition_graph(g, 2, window_cap=16)
    cfg = D.DisReduConfig(mode="async", schedule="edges-only",
                          backend="cuda", descent=True)
    return g, pg, cfg


@pytest.mark.parametrize("algo", ["rg", "rnp"])
def test_staged_solve_on_cuda_matches_cpu(cuda, algo):
    """The staged solve on the card (kernel backend, each rung's plan) ==
    the staged solve of the ``torch`` backend on the CPU == the port's
    monolithic solve on the card: members, descents and path."""
    g, pg, cfg = _staged_case()
    before = kernels.launch_count("segment_fused")
    gm, gst = S.solve_staged(g, 2, algo, cfg, ladder=TWO_RUNGS, pg=pg,
                             device=cuda)
    assert kernels.launch_count("segment_fused") > before
    cm, cst = S.solve_staged(g, 2, algo, dataclasses.replace(
        cfg, backend="torch"), ladder=TWO_RUNGS, pg=pg, device="cpu")
    np.testing.assert_array_equal(gm, cm)
    assert gst["path"] == cst["path"]
    assert gst["descents"] == (2 if algo == "rnp" else 1)
    mono, _ = S.solve(pg, algo, dataclasses.replace(cfg, descent=False),
                      device=cuda)
    np.testing.assert_array_equal(gm, mono)
    assert g.is_independent_set(gm)


def test_kernel_on_each_rung_plan(cuda, tmp_path):
    """``segment_fused`` == its plain version on every rung's plan of a
    staged rnp solve on the card (restored from its checkpoints), with
    the first sweep's payload columns at that rung."""
    from repro_torch.distributed.checkpoint import CheckpointManager

    g, pg, cfg = _staged_case()
    ck = CheckpointManager(str(tmp_path), keep=10, async_write=False)
    _, st = S.solve_staged(g, 2, "rnp", cfg, ladder=TWO_RUNGS, pg=pg,
                           ckpt=ck, device=cuda)
    assert ck.list_steps() == [1, 2]
    prob = D.build_union_problem(pg, "cuda", device=cuda)
    req = E.schedule_requires(E.SCHEDULES["edges-only"])
    for step in ck.list_steps():
        _, _, lp, state, _ = S.restore_staged(ck, pg, prob, cfg,
                                              ladder=TWO_RUNGS, step=step,
                                              device=cuda)
        assert lp.plan.r_blk == {1: 16, 2: 8}[step]
        _, _, dsum, dmax, dor = E.ctx_payloads(
            state, lp.aux, req, window_bits=True, plan=lp.plan)
        n_rows = lp.aux.gid.shape[0]
        kw = dict(r_blk=lp.plan.r_blk, data_sum=dsum, data_max=dmax,
                  data_or=dor, or_nbits=lp.aux.window.shape[1])
        before = kernels.launch_count("segment_fused")
        got = K.segment_fused(lp.plan.edge_perm, lp.plan.lrow, n_rows,
                              extent=lp.plan.extent, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_count("segment_fused") == before + 1
        want = segment_fused_plain(lp.plan.edge_perm, lp.plan.lrow, n_rows,
                                   **kw)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b), step


def test_checkpoint_restored_on_cuda_resumes(cuda, tmp_path):
    """Kill a staged rnp solve on the card after its first descent, restore
    the checkpoint onto the card and finish: bit-identical to the
    uninterrupted run."""
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import InjectedFault

    g, pg, cfg = _staged_case()
    want, st = S.solve_staged(g, 2, "rnp", cfg, ladder=TWO_RUNGS, pg=pg,
                              device=cuda)
    ck = CheckpointManager(str(tmp_path), async_write=True)

    def kill(descents, cell):
        raise InjectedFault(cell)

    with pytest.raises(InjectedFault):
        S.solve_staged(g, 2, "rnp", cfg, ladder=TWO_RUNGS, pg=pg, ckpt=ck,
                       on_descent=kill, device=cuda)
    got, rst = S.solve_staged(g, 2, "rnp", cfg, ladder=TWO_RUNGS, pg=pg,
                              ckpt=ck, resume=True, device=cuda)
    np.testing.assert_array_equal(got, want)
    assert rst["path"] == st["path"]


def _sampled_rows(seeds, fanouts):
    """Edge targets in the reference sampler's layout (seeds first, each
    hop's nodes after, every frontier node taking ``f`` in-edges from the
    next hop): most rows, and so whole row blocks, take no edge."""
    rows, first, frontier = [], 0, seeds
    for f in fanouts:
        rows.append(np.repeat(np.arange(first, first + frontier), f))
        first, frontier = first + frontier, frontier * f
    return np.concatenate(rows).astype(np.int32), first + frontier


def _shuffle_slots(perm, lrow, rng):
    """Permute the slots of every row block: padding lands among the live
    slots and a row's edges are no longer consecutive."""
    order = np.argsort(rng.random(perm.shape), axis=1)
    return (np.take_along_axis(perm, order, axis=1),
            np.take_along_axis(lrow, order, axis=1))


@pytest.mark.parametrize("rows,d,r_blk", [
    ((17, 120), 8, 8), ((64, 9), 128, 8), ((5, 64), 16, 4),
    ((33, 257), 32, 16), ((700, 3000), 602, 64), ((5000, 40000), 128, 8),
    ((900, 4000), 200, 94), ((900, 4000), 200, 95), ((3000, 9000), 130, 452),
    ((1000, 40000), 128, 8), ((300, 2000), 602, 452), ((50, 400), 3, 1),
    ((100, 700), 1, 8), ((16, (3, 2)), 602, 8), ((16, (3, 2)), 130, 8),
    ((64, (3, 2)), 128, 8),
])
@pytest.mark.parametrize("layout", ["packed", "shuffled", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_matches_plain(cuda, rows, d, r_blk, layout,
                                          dtype):
    """Both accumulate in float32 and round once; the kernel sums each row
    in slot order, the plain version on the card by atomics in any order.
    float32: within 1e-5 of the row's sum of |x|; bfloat16: one ulp of the
    result (2^-7 relative) plus that float32 slack.

    ``rows`` is (n_rows, n_edges) with uniform targets, or (seeds, fanouts)
    in the sampler's layout (row blocks with no edge).  Layouts: the slots
    as ``pack_blocks`` packs them; the same slots permuted within each block;
    the payload a view one element past a 16-byte boundary."""
    rng = np.random.default_rng(0)
    if isinstance(rows[1], tuple):
        row, n_rows = _sampled_rows(*rows)
    else:
        n_rows = rows[0]
        row = rng.integers(0, n_rows, size=rows[1]).astype(np.int32)
    n_edges = row.shape[0]
    perm, lrow, _ = pack_blocks(row, n_rows, r_blk=r_blk)
    if layout == "shuffled":
        perm, lrow = _shuffle_slots(perm, lrow, rng)
    data = torch.from_numpy(rng.normal(size=(n_edges, d))).to(cuda, dtype)
    if layout == "offset":
        buf = torch.empty(n_edges * d + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(n_edges, d)
        view.copy_(data)
        data = view
        assert data.data_ptr() % 16 == data.element_size()
    perm = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    lrow = torch.from_numpy(np.ascontiguousarray(lrow)).to(cuda)
    before = kernels.launch_count("segment_sum")
    got = segment_sum_coo(data, perm, lrow, n_rows, r_blk=r_blk)
    torch.cuda.synchronize()
    assert kernels.launch_count("segment_sum") == before + 1
    assert got.dtype == dtype and got.shape == (n_rows, d)
    want = segment_sum_plain(data, perm, lrow, n_rows, r_blk=r_blk).float()
    scale = segment_sum_plain(data.abs(), perm, lrow, n_rows,
                              r_blk=r_blk).float()
    tol = 1e-5 * scale
    if dtype == torch.bfloat16:
        tol = tol + want.abs() * 2.0 ** -7
    assert bool(((got.float() - want).abs() <= tol).all())


def _wedge_case(rng, n_vertices, n_edges, d):
    window = rng.integers(0, n_vertices, size=(n_vertices, d))
    weights = rng.integers(0, 200, size=n_vertices)
    active = rng.integers(0, 2, size=n_vertices).astype(bool)
    row = rng.integers(0, n_vertices, size=n_edges)
    col = rng.integers(0, n_vertices, size=n_edges)
    return (torch.from_numpy(window.astype(np.int32)),
            torch.from_numpy(weights.astype(np.int32)),
            torch.from_numpy(active), torch.from_numpy(row.astype(np.int32)),
            torch.from_numpy(col.astype(np.int32)))


def layout_windows(rng, kind, n_vertices, d):
    """[V, D] int32 windows of one layout; the last vertex plays the nil
    slot (shared with the CPU parity tests, ``tests/test_torch_wedge.py``).

    ``sorted``: ascending distinct entries, nil padding last (the
    partition's layout); ``unsorted``: the same rows shuffled;
    ``duplicates``: entries from a range of 5, so most repeat;
    ``all_nil``: every third row nil only, the rest sorted."""
    nil = n_vertices - 1
    window = np.full((n_vertices, d), nil, dtype=np.int32)
    for v in range(n_vertices):
        if kind == "duplicates":
            window[v] = rng.integers(0, 5, size=d)
            continue
        if kind == "all_nil" and v % 3 == 0:
            continue
        m = int(rng.integers(0, d + 1))
        window[v, :m] = np.sort(rng.choice(nil, size=m, replace=False))
        if kind == "unsorted":
            rng.shuffle(window[v])
    return window


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "duplicates",
                                  "all_nil"])
@pytest.mark.parametrize("d", [4, 5, 8, 16, 32])
@pytest.mark.parametrize("n_edges", [1, 255, 4099])
def test_wedge_intersect_kernel_window_layouts(cuda, kind, d, n_edges):
    """Sorted (the partition's layout), unsorted, duplicate-heavy and
    nil-only windows, the nil slot active so nil entries count where they
    match, at edge counts that fill no block exactly: exact."""
    rng = np.random.default_rng(d * 7 + n_edges)
    n_vertices = 300
    active = rng.integers(0, 2, size=n_vertices).astype(bool)
    active[-1] = True
    args = (torch.from_numpy(layout_windows(rng, kind, n_vertices, d)),
            torch.from_numpy(rng.integers(0, 200, size=n_vertices)
                             .astype(np.int32)),
            torch.from_numpy(active),
            torch.from_numpy(rng.integers(0, n_vertices, size=n_edges)
                             .astype(np.int32)),
            torch.from_numpy(rng.integers(0, n_vertices, size=n_edges)
                             .astype(np.int32)))
    got = common_neighbor_stats(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    for g, w in zip(got, common_neighbor_stats_ref(*args)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("p,window_cap", [(1, 16), (4, 16), (4, 8), (4, 32)])
def test_wedge_intersect_kernel_on_a_partition(cuda, p, window_cap):
    """The union problem of a partitioned RGG (sorted windows, nil padding
    last, edges sorted by row), all vertices active and the nil slots
    too: exact."""
    g = gen.rgg2d(3000, avg_deg=10, seed=5)
    pg = part.partition_graph(g, p, window_cap=window_cap)
    prob = D.build_union_problem(pg, "torch", device="cpu")
    aux = prob.aux
    active = torch.ones(aux.window.shape[0], dtype=torch.bool)
    args = (aux.window, prob.w0, active, aux.row, aux.col)
    got = common_neighbor_stats(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    for g_, w in zip(got, common_neighbor_stats_ref(*args)):
        assert torch.equal(g_.cpu(), w)


@pytest.mark.parametrize("n_vertices,n_edges,d", [
    (51, 100, 8), (51, 513, 16), (51, 7, 4), (40, 300, 7), (30, 200, 32),
    (1000, 20000, 16), (200, 1000, 12),
])
def test_wedge_intersect_kernel_matches_plain(cuda, n_vertices, n_edges, d):
    """All int32: exact."""
    args = _wedge_case(np.random.default_rng(1), n_vertices, n_edges, d)
    before = kernels.launch_count("wedge_intersect")
    got = common_neighbor_stats(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert kernels.launch_count("wedge_intersect") == before + 1
    want = common_neighbor_stats_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("d", [4, 5, 8, 16, 32])
def test_wedge_intersect_kernel_takes_an_unaligned_window(cuda, d):
    """A window that starts 4 bytes past a 16-byte boundary (a view at an
    odd element) takes the element-wise reads, not the 16-byte vectors."""
    args = _wedge_case(np.random.default_rng(3), 300, 2000, d)
    buf = torch.empty(args[0].numel() + 1, dtype=torch.int32, device=cuda)
    window = buf[1:].view(args[0].shape)
    window.copy_(args[0])
    assert window.is_contiguous() and window.data_ptr() % 16 == 4
    got = common_neighbor_stats(window, *(a.to(cuda) for a in args[1:]))
    torch.cuda.synchronize()
    for g, w in zip(got, common_neighbor_stats_ref(*args)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("V,B,K_,D", [
    (100, 33, 4, 16), (64, 8, 1, 128), (500, 70, 7, 32), (100, 9, 3, 5),
    (100_000, 8192, 4, 128), (2000, 512, 32, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_matches_plain(cuda, V, B, K_, D, dtype):
    """Both accumulate in float32 and round once.  float32: the JAX test's
    1e-5 (rtol and atol); bfloat16: one ulp of the result (2^-7 relative)
    on top of 1e-5 of the bag's sum of |w x|, which a kernel adding in
    bfloat16 would exceed at K = 32."""
    _check_embedding_bag(cuda, V, B, K_, D, dtype)


def _check_embedding_bag(cuda, V, B, K_, D, dtype):
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(V, D))).to(cuda, dtype)
    idx = torch.from_numpy(rng.integers(0, V, size=(B, K_)).astype(np.int32))
    wgt = torch.from_numpy(rng.normal(size=(B, K_)).astype(np.float32))
    before = kernels.launch_count("embedding_bag")
    got = embedding_bag(table, idx.to(cuda), wgt.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launch_count("embedding_bag") == before + 1
    assert got.dtype == dtype and got.shape == (B, D)
    want = embedding_bag_ref(table, idx.to(cuda), wgt.to(cuda)).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got.float(), want, rtol=1e-5, atol=1e-5)
    else:
        scale = embedding_bag_ref(table.float().abs(), idx.to(cuda),
                                  wgt.abs().to(cuda))
        tol = 1e-5 * scale + want.abs() * 2.0 ** -7
        assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("K_", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("D", [8, 16, 24, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_bag_sizes(cuda, K_, D, dtype):
    """Narrow rows (lane groups owning whole bags) and wide ones (a
    warp a bag) at bags of 1 to 7 lookups, over a batch of 1,001 bags, a
    multiple of no block's bags; tolerances as above."""
    _check_embedding_bag(cuda, 5000, 1001, K_, D, dtype)


def test_new_kernels_reject_other_dtypes(cuda):
    perm = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    lrow = torch.full((1, 8), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.segment_sum(torch.zeros((1, 4), dtype=torch.float64, device=cuda),
                      perm, lrow, 8, r_blk=8)
    win = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    ones = torch.ones(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        WK.wedge_intersect(win, ones, ones.bool(), ones, ones)
    with pytest.raises(TypeError, match="float32"):
        EK.embedding_bag(torch.zeros((4, 8), device=cuda),
                         torch.zeros((2, 2), dtype=torch.int32, device=cuda),
                         torch.zeros((2, 2), dtype=torch.float64,
                                     device=cuda))


def _plain_lookup(table, idx, host_idx=None):
    """The DLRM lookup through the kernel's plain version on the card."""
    rows = idx.contiguous()[:, None]
    return embedding_bag_ref(table, rows, torch.ones(rows.shape,
                                                     device=rows.device))


@pytest.mark.parametrize("full_widths", [False, True],
                         ids=["smoke", "full-widths-64-rows"])
def test_dlrm_through_the_kernel_equals_the_plain_lookup(cuda, monkeypatch,
                                                         full_widths):
    """26 launches a forward and 1 a retrieval; every output bit for bit
    the plain lookup's on the card, and within float32 rounding (rtol
    1e-5, atol 1e-6) of the CPU run."""
    cfg = dlrm_mlperf.SMOKE
    if full_widths:
        cfg = dataclasses.replace(dlrm_mlperf.CONFIG, vocabs=tuple(
            min(v, 64) for v in DM.MLPERF_VOCABS))
    params = MC.init_params(DM.param_specs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    cpu = DM.DLRM(cfg, params)
    model = DM.DLRM(cfg, params).to(cuda)
    b = dlrm_batch(DLRMBatchSpec(300, cfg.n_dense, cfg.n_sparse,
                                 cfg.vocabs), 0)
    rng = np.random.default_rng(1)
    q = dict(dense=b["dense"][:1], candidates=rng.integers(
        0, cfg.vocabs[0], size=(1, 1000)).astype(np.int32))

    def run(device, m):
        tb = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        tq = {k: torch.from_numpy(v).to(device) for k, v in q.items()}
        with torch.no_grad():
            return (DM.forward(m, tb, cfg), DM.serve_step(m, tb, cfg),
                    DM.loss_fn(m, tb, cfg), DM.retrieval_step(m, tq, cfg))

    before = kernels.launch_count("embedding_bag")
    got = run(cuda, model)
    torch.cuda.synchronize()
    assert kernels.launch_count("embedding_bag") - before == 3 * 26 + 1
    monkeypatch.setattr(DM, "embedding_bag", _plain_lookup)
    before = kernels.launch_count("embedding_bag")
    want = run(cuda, model)
    torch.cuda.synchronize()
    assert kernels.launch_count("embedding_bag") == before
    for g, w, c in zip(got, want, run("cpu", cpu)):
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_lm_decode_on_cuda_matches_cpu(cuda):
    """gemma3-1b's SMOKE config in float32, 6 steps from a seeded cache:
    logits within 1e-4 of the largest, greedy tokens equal, no kernel
    launched (the LM path has none)."""
    cfg = dataclasses.replace(gemma3_1b.SMOKE, dtype=torch.float32)
    params = MC.init_params(TM.param_specs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    cpu, card = TM.Transformer(cfg, params), TM.Transformer(cfg, params)
    card = card.to(cuda)
    ((shape, dt), _), _ = TM.make_kv_cache_specs(cfg, 2, 16)
    gen = torch.Generator().manual_seed(1)
    kc = torch.randn(shape, generator=gen, dtype=dt)
    vc = torch.randn(shape, generator=gen, dtype=dt)
    caches = {"cpu": (kc.clone(), vc.clone()),
              "cuda": (kc.to(cuda), vc.to(cuda))}
    toks = {d: torch.zeros((2, 1), dtype=torch.int32, device=d)
            for d in caches}
    before = sum(kernels.launch_count(k) for k in kernels.KERNELS)
    with torch.no_grad():
        for n in range(8, 14):
            out = {d: TM.serve_step(m, caches[d], toks[d], n, cfg)[0]
                   for d, m in (("cpu", cpu), ("cuda", card))}
            want, got = out["cpu"], out["cuda"].cpu()
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
            assert torch.equal(got.argmax(-1), want.argmax(-1))
            toks = {d: out[d].argmax(-1)[:, None].to(torch.int32)
                    for d in out}
    assert sum(kernels.launch_count(k) for k in kernels.KERNELS) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_out_of_range_ids(cuda, dtype):
    """Ids V, V + 3, -1, -V and -V - 1 at D 128 (float32: the wide kernel;
    bfloat16: the narrow one), bags of 1 and 3: the kernel reads the rows
    its plain version reads (wrap once, then clamp): within the
    tolerances above (bit for bit at one lookup a bag), and bit for bit
    the kernel's own result on those rows given in range; -1 is a row
    (the last), not a skipped lookup."""
    gen = torch.Generator().manual_seed(6)
    V, D = 300, 128
    table = torch.randn((V, D), generator=gen).to(dtype).to(cuda)
    odd = torch.tensor([V, V + 3, -1, -V, -V - 1], dtype=torch.int32)
    for k_bag in (1, 3):
        idx = torch.randint(0, V, (5, k_bag), generator=gen,
                            dtype=torch.int32)
        idx[:, 0] = odd
        wgt = torch.randn((5, k_bag), generator=gen)
        got = embedding_bag(table, idx.to(cuda), wgt.to(cuda))
        want = embedding_bag_ref(table, idx.to(cuda), wgt.to(cuda)).float()
        if k_bag == 1:
            assert torch.equal(got.float(), want)
        elif dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            scale = embedding_bag_ref(table.float().abs(), idx.to(cuda),
                                      wgt.abs().to(cuda))
            tol = 1e-5 * scale + want.abs() * 2.0 ** -7
            assert bool(((got.float() - want).abs() <= tol).all())
        rows = torch.where(idx < 0, idx + V, idx).clamp(0, V - 1)
        assert rows[:, 0].tolist() == [V - 1, V - 1, V - 1, 0, 0]
        assert torch.equal(got, embedding_bag(table, rows.to(cuda),
                                              wgt.to(cuda)))


@pytest.fixture
def fp32_matmul():
    """float32 matmuls without TF32, as the CPU computes them."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def test_flash_attention_on_cuda_matches_cpu(cuda, fp32_matmul):
    """The flash Function's forward within 1e-5 and its (q, k, v)
    gradients within 1e-4 of each one's largest magnitude, float32,
    GQA with a window over several tiles."""
    gen = torch.Generator().manual_seed(2)
    shapes = ((2, 100, 8, 16), (2, 100, 2, 16), (2, 100, 2, 16))
    base = [torch.randn(s, generator=gen) for s in shapes]
    outs = {}
    for dev in ("cpu", cuda):
        qkv = [t.clone().to(dev).requires_grad_() for t in base]
        out = MC.flash_attention(*qkv, 25, chunk=32)
        (out.float() ** 2).sum().backward()
        outs[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in qkv]
    want, got = outs["cpu"], outs[str(cuda)]
    assert (got[0] - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
    for g, w in zip(got[1:], want[1:]):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_moe_kept_set_on_cuda_matches_cpu(cuda, fp32_matmul):
    """qwen3-moe SMOKE's MoE layer at capacity_factor 0.5 (assignments
    dropped): the same routing, kept set and slots on the card; the
    output within 1e-5 of the largest."""
    from repro_torch.configs import qwen3_moe_235b

    cfg = dataclasses.replace(qwen3_moe_235b.SMOKE, dtype=torch.float32,
                              capacity_factor=0.5)
    params = MC.init_params(TM.param_specs(cfg),
                            torch.Generator().manual_seed(3), "cpu")
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    res = {}
    for dev in ("cpu", cuda):
        lp = TM._layers(TM.Transformer(cfg, params).to(dev).ffn)[0]
        with torch.no_grad():
            h = MC.rms_norm(x.to(dev), lp["norm"]).reshape(-1, cfg.d_model)
            idx = torch.topk(torch.softmax(h @ lp["router"], -1),
                             cfg.moe_top_k, -1).indices.reshape(-1)
            cap = int(max(1, round(idx.numel() / cfg.moe_experts
                                   * cfg.capacity_factor)))
            keep, slot = TM._dispatch(idx, cfg.moe_experts, cap)
            y, _ = TM._moe_ffn(x.to(dev), lp, cfg)
        res[str(dev)] = (idx.cpu(), keep.cpu(), slot.cpu(), y.cpu())
    want, got = res["cpu"], res[str(cuda)]
    assert 0 < int(want[1].sum()) < want[1].numel()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert (got[3] - want[3]).abs().max() <= 1e-5 * want[3].abs().max()


def test_adamw_step_on_cuda_matches_cpu(cuda):
    """One AdamW update of a float32 / bfloat16 tree from the same grads
    and state: float32 leaves and moments within float32 rounding, the
    bfloat16 weight within one ulp."""
    from repro_torch.train import optimizer as opt

    gen = torch.Generator().manual_seed(5)
    params = {"a": torch.randn((64, 32), generator=gen),
              "b": {"w": torch.randn((4, 8, 16), generator=gen)
                    .to(torch.bfloat16)}}
    grads = opt.tree_map(lambda p: torch.randn(p.shape, generator=gen)
                         .to(p.dtype), params)
    cfg = opt.AdamWConfig(lr=0.01)
    res = {}
    for dev in ("cpu", cuda):
        p = opt.tree_map(lambda t: t.to(dev), params)
        g = opt.tree_map(lambda t: t.to(dev), grads)
        p2, st = opt.adamw_update(g, opt.adamw_init(p), p, cfg)
        res[str(dev)] = [t.cpu() for t in opt.leaves(p2) + opt.leaves(st)]
    for g, w in zip(res[str(cuda)], res["cpu"]):
        assert g.dtype == w.dtype
        if w.dtype == torch.bfloat16:
            ulp = 2.0 ** (torch.floor(torch.log2(w.float().abs())) - 7)
            assert ((g.float() - w.float()).abs() <= ulp).all()
        else:
            torch.testing.assert_close(g, w, rtol=2e-6, atol=1e-7)


def _bwd_case(cuda, V, B, K_, D, dtype, seed=7, draw="uniform"):
    """Ids by ``draw``: uniform in [0, V); ``one_row``, every lookup on row
    V // 2; ``zipf``, numpy's Zipf (a 1.05) folded into [0, V); ``dropped``,
    uniform in [-V - 3, V + 3), so each tile mixes ids out of range after
    the wrap (weight NaN, as DLRM's lookup gives them) with live ids of the
    same wrapped rows."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, V, (B, K_), generator=gen, dtype=torch.int32)
    wgt = torch.randn((B, K_), generator=gen)
    cot = torch.randn((B, D), generator=gen).to(dtype)
    if draw == "one_row":
        idx.fill_(V // 2)
    elif draw == "zipf":
        z = np.random.default_rng(seed).zipf(1.05, (B, K_))
        idx = torch.from_numpy((z - 1) % V).to(torch.int32)
    elif draw == "dropped":
        idx = torch.randint(-V - 3, V + 3, (B, K_), generator=gen,
                            dtype=torch.int32)
        wrapped = torch.where(idx < 0, idx + V, idx)
        wgt[(wrapped < 0) | (wrapped >= V)] = float("nan")
    return cot.to(cuda), idx.to(cuda), wgt.to(cuda)


def _check_bwd(got, cot, idx, wgt, V, dtype):
    """Kernel vs plain version (both accumulate in float32 and round once;
    atomics and ``index_add_`` add in any order).  float32: within 1e-6 of
    each row's Σ|w·g| (per column), which at one or two lookups a row is
    1e-6 of the entry, and covers a hot row's thousands of terms summed
    in another order; bfloat16: one bfloat16 ulp of the largest entry
    (2^-7 of it) on top."""
    want = embedding_bag_bwd_ref(cot, idx, wgt, V, dtype).float()
    scale = embedding_bag_bwd_ref(cot.float().abs(), idx, wgt.abs(), V,
                                  torch.float32)
    tol = 1e-6 * scale
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.abs().max()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("V,B,K_,D,draw", [
    (100, 33, 4, 16, "uniform"), (64, 8, 1, 128, "uniform"),
    (500, 70, 7, 32, "uniform"), (100, 9, 3, 5, "uniform"),
    (100_000, 8192, 4, 128, "uniform"), (3, 65_536, 1, 128, "uniform"),
    (4, 4096, 4, 16, "uniform"), (3, 16_384, 4, 128, "uniform"),
    (1000, 65_536, 1, 128, "one_row"), (100_000, 65_536, 1, 128, "zipf"),
    (5, 4096, 2, 128, "dropped"), (3, 4096, 1, 5, "uniform"),
    (50, 8192, 2, 256, "uniform"), (4, 4096, 2, 37, "zipf"),
    (7, 1000, 1, 128, "uniform"), (7, 333, 3, 128, "uniform"),
    (100, 8192, 4, 128, "uniform"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_backward_kernel_matches_plain(cuda, V, B, K_, D,
                                                     draw, dtype):
    """The table's gradient through the op on the card: one launch of the
    backward kernel, within the tolerance of ``_check_bwd``.  D 5 and 37
    take the scalar path; D 256 and 37 span two column chunks of a block;
    V 3 and 4 are DLRM's hot rows (every bag on a handful of rows; at K 4
    a row repeats inside a bag); every lookup on one row; Zipf ids; ids
    dropped after the wrap, NaN weights, beside live lookups of the same
    wrapped rows; 1,000 and 999 lookups, not a multiple of the tile (at
    K 3 a tile ends inside a bag); V 100 at K 4, more repeated rows in a
    tile than it stages."""
    cot, idx, wgt = _bwd_case(cuda, V, B, K_, D, dtype, draw=draw)
    table = torch.zeros((V, D), dtype=dtype, device=cuda,
                        requires_grad=True)
    before = kernels.launch_count("embedding_bag_backward")
    embedding_bag(table, idx, wgt).backward(cot)
    torch.cuda.synchronize()
    assert kernels.launch_count("embedding_bag_backward") == before + 1
    _check_bwd(table.grad, cot, idx, wgt, V, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_backward_kernel_drops_out_of_range_ids(cuda, dtype):
    """Ids V, V + 3, -1, -V and -V - 1 with NaN weights on the ones out of
    range after the wrap (DLRM's lookup gives them NaN): the kernel drops
    them before it reads the weight, so the gradient is finite and equals
    the plain version's; -1 and -V add to rows V - 1 and 0."""
    V, D = 300, 128
    cot, idx, wgt = _bwd_case(cuda, V, 5, 3, D, dtype, seed=8)
    idx[:, 0] = torch.tensor([V, V + 3, -1, -V, -V - 1], device=cuda)
    wgt[[0, 1, 4], 0] = float("nan")
    got = EK.embedding_bag_bwd(cot, idx, wgt, V)
    assert bool(torch.isfinite(got).all())
    _check_bwd(got.to(dtype), cot, idx, wgt, V, dtype)


def test_embedding_bag_backward_adds_into_a_given_buffer(cuda):
    """``out=``: the kernel adds into the buffer it is given (what the
    chip script times without the zero fill)."""
    cot, idx, wgt = _bwd_case(cuda, 50, 40, 2, 8, torch.float32)
    first = EK.embedding_bag_bwd(cot, idx, wgt, 50)
    twice = EK.embedding_bag_bwd(cot, idx, wgt, 50, out=first.clone())
    torch.testing.assert_close(twice, 2 * first, rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="float32"):
        EK.embedding_bag_bwd(cot, idx, wgt.double(), 50)


def test_dlrm_train_step_on_cuda_matches_cpu(cuda, fp32_matmul):
    """DLRM's SMOKE ``loss_fn`` under autograd on the card: 26 forward and
    26 backward ``embedding_bag`` launches; the loss within 1e-5 relative
    and every weight's gradient within 1e-4 of its largest of the CPU
    run's."""
    from repro_torch.configs.smoke_runners import dlrm_smoke_batches
    from repro_torch.train.step import loss_and_grads

    cfg = dlrm_mlperf.SMOKE
    params = MC.init_params(DM.param_specs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    params = MC.nest({n: t * 8.0 for n, t in MC._leaves(params)})
    batch, _ = dlrm_smoke_batches(cfg)
    res = {}
    for dev in ("cpu", cuda):
        before = {k: kernels.launch_count(k) for k in kernels.KERNELS}
        tree = MC.nest({n: t.to(dev) for n, t in MC._leaves(params)})
        loss, grads = loss_and_grads(
            tree, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            cfg, model_cls=DM.DLRM, loss_fn=DM.loss_fn)
        torch.cuda.synchronize()
        res[str(dev)] = (float(loss), {n: g.cpu() for n, g in
                                       MC._leaves(grads)},
                         {k: kernels.launch_count(k) - before[k]
                          for k in kernels.KERNELS})
    (lc, gc, nc), (lg, gg, ng) = res["cpu"], res[str(cuda)]
    assert not any(nc.values())
    assert ng == {**{k: 0 for k in ng}, "embedding_bag": 26,
                  "embedding_bag_backward": 26}
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k, w in gc.items():
        assert (gg[k] - w).abs().max() <= 1e-4 * w.abs().max(), k


@pytest.mark.parametrize("arch", ["graphsage", "gatedgcn", "dimenet",
                                  "equiformer"])
def test_gnn_step_on_cuda_matches_cpu(cuda, fp32_matmul, arch):
    """Each GNN's SMOKE ``loss_fn`` under autograd on the smoke runner's
    batch, float32 (equiformer's act_dtype too): ``segment_sum`` launches
    on the card and no other kernel; the loss within 1e-5 relative and
    every weight's gradient within 1e-4 of its largest of the CPU run's
    (gradients exactly 0 held to 1e-6 of the model's largest)."""
    from repro_torch.configs import (
        dimenet_cfg, equiformer_v2_cfg, gatedgcn_cfg, graphsage_reddit,
    )
    from repro_torch.configs.smoke_runners import gnn_smoke_batch
    from repro_torch.train.step import loss_and_grads

    mod, molecular, sampled = {
        "graphsage": (graphsage_reddit, False, True),
        "gatedgcn": (gatedgcn_cfg, False, False),
        "dimenet": (dimenet_cfg, True, False),
        "equiformer": (equiformer_v2_cfg, True, False)}[arch]
    cfg = mod.SMOKE
    if arch == "equiformer":
        cfg = dataclasses.replace(cfg, act_dtype=torch.float32)
    params = MC.init_params(mod.module.param_specs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    batch = gnn_smoke_batch(cfg, molecular=molecular, sampled=sampled)
    res = {}
    for dev in ("cpu", cuda):
        before = {k: kernels.launch_count(k) for k in kernels.KERNELS}
        tree = MC.nest({n: t.to(dev) for n, t in MC._leaves(params)})
        tb = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
              else v for k, v in batch.items()}
        loss, grads = loss_and_grads(tree, tb, cfg,
                                     model_cls=mod.module.MODEL,
                                     loss_fn=mod.module.loss_fn)
        torch.cuda.synchronize()
        res[str(dev)] = (float(loss), {n: g.cpu() for n, g in
                                       MC._leaves(grads)},
                         {k: kernels.launch_count(k) - before[k]
                          for k in kernels.KERNELS})
    (lc, gc, nc), (lg, gg, ng) = res["cpu"], res[str(cuda)]
    assert not any(nc.values())
    assert ng["segment_sum"] > 0
    assert not any(v for k, v in ng.items() if k != "segment_sum")
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    floor = 1e-6 * max(float(w.abs().max()) for w in gc.values())
    for k, w in gc.items():
        assert (gg[k] - w).abs().max() <= 1e-4 * max(float(
            w.abs().max()), floor), k


def _to(tree, dev):
    """A copy of an input tree (dicts, lists, tuples, named ones included)
    with every tensor on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


@pytest.mark.parametrize("arch_id,module,shape,cut", [
    ("gemma3-1b", "gemma3_1b", "train_4k", dict(seq=64, batch=2)),
    ("gemma3-1b", "gemma3_1b", "decode_32k", dict(seq=64, batch=2)),
    ("dlrm-mlperf", "dlrm_mlperf", "train_batch", {}),
    ("dlrm-mlperf", "dlrm_mlperf", "retrieval_cand", {}),
    ("graphsage-reddit", "graphsage_reddit", "full_graph_sm", {}),
    ("gatedgcn", "gatedgcn_cfg", "molecule", {}),
])
def test_work_count_on_cuda_matches_cpu(cuda, arch_id, module, shape, cut):
    """The dry-run's work counter on a SMOKE cell's step: the same inputs
    (made on the CPU) counted on the card and on the CPU give the same
    FLOPs (and by class), transcendentals, bytes, collectives and kernel
    units / operations / bytes (the
    card launches the kernels, the CPU runs their plain versions), and on
    the card each kernel's units are its launches."""
    import importlib

    from repro_torch.analysis import count
    from repro_torch.configs import registry

    smoke = importlib.import_module(f"repro_torch.configs.{module}").SMOKE
    ov = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
          if f.name != "name"}
    built = registry.get(arch_id).build(shape, {**ov, **cut})
    inputs = built.make_inputs("cpu", 0)
    before = {k: kernels.launch_count(k) for k in kernels.KERNELS}
    _, card = count.measure(built.fn, _to(inputs, cuda), cuda)
    launched = {k: n for k in kernels.KERNELS
                if (n := kernels.launch_count(k) - before[k])}
    _, cpu = count.measure(built.fn, inputs, "cpu")
    for k in ("flops", "transcendentals", "flops_by_class", "bytes",
              "collectives", "kernels"):
        assert card[k] == cpu[k], (k, {
            op: (card["by_op"].get(op), cpu["by_op"].get(op))
            for op in set(card["by_op"]) | set(cpu["by_op"])
            if card["by_op"].get(op) != cpu["by_op"].get(op)})
    assert {k: v["units"] for k, v in card["kernels"].items()} == launched
    assert card["memory"]["temp_bytes"] is not None
    assert cpu["memory"]["temp_bytes"] is None


@pytest.mark.parametrize("arch_id,module,shape,cut", [
    ("gemma3-1b", "gemma3_1b", "train_4k", dict(seq=64, batch=2)),
    ("gemma3-1b", "gemma3_1b", "decode_32k", dict(seq=64, batch=2)),
    ("qwen3-moe-235b-a22b", "qwen3_moe_235b", "train_4k",
     dict(seq=32, batch=2)),
    ("dlrm-mlperf", "dlrm_mlperf", "train_batch", {}),
    ("dlrm-mlperf", "dlrm_mlperf", "retrieval_cand", {}),
    ("graphsage-reddit", "graphsage_reddit", "full_graph_sm", {}),
    ("dimenet", "dimenet_cfg", "molecule", {}),
])
def test_meta_count_matches_cuda(cuda, arch_id, module, shape, cut):
    """The dry-run's abstract count: a SMOKE cell's step counted on meta
    and on the card, from the same index arrays drawn on the host, gives
    the same FLOPs (and by class), transcendentals, bytes, transfer bytes
    (the GNN
    plans' uploads), collectives and kernel units / operations / bytes;
    on the card each kernel's units are its launches, and the card
    reports its storage tally beside its allocator's peak."""
    import importlib

    from repro_torch.analysis import count
    from repro_torch.configs import registry

    smoke = importlib.import_module(f"repro_torch.configs.{module}").SMOKE
    ov = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
          if f.name != "name"}
    built = registry.get(arch_id).build(shape, {**ov, **cut})
    _, meta = count.measure(built.fn, built.make_inputs("meta", 0), "meta")
    inputs = built.make_inputs(cuda, 0)
    before = {k: kernels.launch_count(k) for k in kernels.KERNELS}
    _, card = count.measure(built.fn, inputs, cuda, tally=True)
    launched = {k: n for k in kernels.KERNELS
                if (n := kernels.launch_count(k) - before[k])}
    for k in ("flops", "transcendentals", "flops_by_class", "bytes",
              "transfer_bytes", "collectives", "kernels"):
        assert card[k] == meta[k], (k, card[k], meta[k])
    assert {k: v["units"] for k, v in card["kernels"].items()} == launched
    assert meta["memory"]["temp_bytes"] > 0
    assert card["memory"]["tally_temp_bytes"] > 0
    assert card["memory"]["argument_bytes"] == meta["memory"][
        "argument_bytes"]


def test_dryrun_cell_on_cuda(cuda, tmp_path):
    """A dry-run cell through the CLI's probe route (``--probes``) on the
    card at SMOKE widths: probes L 2, 4, a record for every mesh, the
    card's name and power limit in it, temp bytes measured."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    ov = [x for kv in ("d_model=64", "n_heads=4", "d_head=16", "d_ff=128",
                       "vocab=128", "attn_chunk=16", "seq=64", "batch=2")
          for x in ("--override", kv)]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "train_4k", "--probes", "--mesh", "card",
         "--out", str(tmp_path), *ov],
        env=dict(os.environ, PYTHONPATH=str(src)),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((tmp_path / "gemma3-1b__train_4k__card.json")
                     .read_text())
    assert rec["ok"] and rec["device"]["platform"] == "gpu"
    assert rec["device"]["nvidia_smi"]
    assert rec["memory"]["temp_bytes"] > 0
    assert [p["tag"] for p in rec["probes"]] == ["L4", "L2"]
