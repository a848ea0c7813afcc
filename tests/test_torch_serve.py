"""Port parity of batched MWIS serving: ``repro_torch.core.serve`` against
``repro.core.serve`` on the same requests (members and weight identical,
on both of the port's CPU backends, for greedy / rg / rnp), batched against
the port's single-instance solve, the plan cache and plan stacking against
the reference's, bucketing, per-request isolation, the fallback chain and
the ``launch.serve`` CLI (the pipeline and the serve mesh:
``test_torch_serve_pipeline.py``)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import serve as JSV
from repro.core import validate as JV
from repro.core.graph import Graph as JGraph
from repro.core.partition import partition_graph as jpartition
from repro.graphs import generators as jgen
from repro.launch import serve as jlaunch
from repro_torch.core import distributed as TD
from repro_torch.core import engine as TE
from repro_torch.core import partition as tpart
from repro_torch.core import serve as TSV
from repro_torch.core import solvers as TS
from repro_torch.core import validate as TV
from repro_torch.core.graph import Graph as TGraph
from repro_torch.graphs import generators as tgen

from _torch_jax import _release_jax_programs  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(gen, shapes, repeat, seed=0):
    """Each (n, m) GNM topology ``repeat`` times with fresh weights in
    [1, 200], made with numpy from ``seed`` (the same for both packages)."""
    rng = np.random.default_rng(seed)
    out = []
    for t, (n, m) in enumerate(shapes):
        g = gen.gnm(n, m, seed=seed + t)
        for _ in range(repeat):
            w = rng.integers(1, 201, size=g.n).astype(np.int32)
            out.append(type(g)(indptr=g.indptr, indices=g.indices,
                               weights=w))
    return out


def _tsvc(**kw):
    return TSV.MWISService(TSV.ServeConfig(device="cpu", **kw))


def _same(got, want, label):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.ok == w.ok and g.reason == w.reason, (label, i)
        assert g.weight == w.weight, (label, i)
        np.testing.assert_array_equal(g.members, w.members,
                                      err_msg=f"{label} request {i}")


# --------------------------------------------------------------------- #
# the service against the reference's
# --------------------------------------------------------------------- #

#: serve_xs at batch 4 (2 topologies x 2 weightings) and serve_s at batch
#: 16 (4 x 4) in one solve_batch call.
XS_S = ([(51, 102), (40, 80)], 2), ([(204, 408), (150, 300), (204, 380),
                                     (180, 360)], 4)


@pytest.mark.parametrize("algo", ["greedy", "rg", "rnp"])
def test_service_matches_reference(algo):
    """Members and weight of every request identical to the JAX service
    (``jnp`` and ``blocked``, pipeline off) on the port's ``torch`` and
    ``blocked`` backends."""
    def reqs(gen):
        return [g for shapes, rep in XS_S
                for g in _requests(gen, shapes, rep, seed=7)]

    jreqs, treqs = reqs(jgen), reqs(tgen)
    want = JSV.MWISService(JSV.ServeConfig(
        algo=algo, backend="jnp", max_batch=16, pipeline=False,
    )).solve_batch(jreqs)
    assert all(r.ok for r in want)
    jblk = JSV.MWISService(JSV.ServeConfig(
        algo=algo, backend="blocked", max_batch=16, pipeline=False,
    )).solve_batch(jreqs)
    _same(jblk, want, f"{algo}: reference blocked vs jnp")
    for backend in ("torch", "blocked"):
        svc = _tsvc(algo=algo, backend=backend, max_batch=16)
        _same(svc.solve_batch(treqs), want, f"{algo}/{backend}")
        st = svc.stats
        assert st["chunks"] == 2 and st["backend_active"] == backend
        assert st["cache_misses"] == 6 and st["cache_hits"] == 14


def _single(g, algo, backend):
    """The port's unbatched single-instance solve on the same cell."""
    cell = TSV.bucket_for(g.n, g.num_directed_edges)
    pg = tpart.partition_graph(
        g, 1, window_cap=cell.D, common_cap=cell.Dc,
        pad_to=dict(L=cell.L, G=cell.G, E=cell.E, B=cell.B, S=cell.S),
    )
    cfg = TD.DisReduConfig(
        backend=backend, r_blk=None if backend == "torch" else cell.r_blk,
        schedule=cell.schedule, max_rounds=64,
    )
    members, _ = TS.solve(pg, algo, cfg, device="cpu")
    return members


@pytest.mark.parametrize("algo,backend", [
    ("greedy", "blocked"), ("rg", "torch"), ("rg", "blocked"),
    ("rnp", "torch"), ("rnp", "cuda"),
])
def test_batched_matches_single_instance(algo, backend):
    """Stacked into one union problem, each request gets the port's own
    single-instance result (the ``cuda`` backend takes the kernel's plain
    version on CPU tensors); a ragged chunk of 3 pads to batch 4."""
    graphs = _requests(tgen, [(30, 60), (45, 100), (60, 130)], 1, seed=3)
    res = _tsvc(algo=algo, backend=backend).solve_batch(graphs)
    for g, r in zip(graphs, res):
        assert r.ok and r.members.shape == (g.n,)
        np.testing.assert_array_equal(r.members, _single(g, algo, backend))
        assert r.weight == int(g.weights[r.members].sum())
        assert g.is_independent_set(r.members)


def test_stacked_problem_is_the_union_of_its_instances():
    """stack_problems offsets every vertex index by b*V, remaps the halo's
    board padding to B*V and keeps the per-instance fields."""
    cell = TSV.serve_cells()[0]
    probs = []
    for g in _requests(tgen, [(30, 60), (40, 70)], 1):
        probs.append(TSV._pack_topology(g, cell, "blocked", "cpu").prob)
    st = TD.stack_problems(probs + probs[-1:])
    V = probs[0].V
    assert (st.p, st.V) == (3, V) and st.w0.shape == (3 * V,)
    for b, p in enumerate(probs + probs[-1:]):
        e = p.aux.row.shape[0]
        assert torch.equal(st.aux.row[b * e:(b + 1) * e], p.aux.row + b * V)
        assert torch.equal(st.aux.window[b * V:(b + 1) * V],
                           p.aux.window + b * V)
        assert torch.equal(st.aux.gid[b * V:(b + 1) * V], p.aux.gid)
        pad = p.halo.iface_slots[0] == V
        assert torch.equal(st.halo.iface_slots[b][pad],
                           torch.full_like(p.halo.iface_slots[0][pad], 3 * V))
    assert st.plan.edge_perm.shape[0] == 3
    assert st.plan.edge_perm.shape[2] == max(p.plan.edge_perm.shape[1]
                                             for p in probs)
    assert st.plan.wbits.shape == (3 * probs[0].aux.row.shape[0],)


# --------------------------------------------------------------------- #
# plans: stack_plans / pad_plan / aggregate_batched against the reference
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("jb,tb", [("jnp", "torch"), ("blocked", "blocked"),
                                   ("blocked", "cuda")])
def test_aggregate_batched_matches_reference(jb, tb):
    rng = np.random.default_rng(2)
    n_rows, n_edges, B = 16, 48, 3
    seg = np.sort(rng.integers(0, n_rows, size=n_edges)).astype(np.int32)
    dsum = rng.integers(-1000, 1000, size=(B, n_edges)).astype(np.int32)
    dmax = rng.integers(-1000, 1000, size=(B, n_edges, 2)).astype(np.int32)
    dor = rng.integers(0, 1 << 12, size=(B, n_edges, 2)).astype(np.int32)
    seg_b = np.broadcast_to(seg, (B, n_edges)).copy()
    jplan = tplan = None
    if jb == "blocked":
        jplan = JE.stack_plans([JE.build_plan(seg, n_rows, r_blk=8)] * B)
        tplan = TE.stack_plans([TE.build_plan(seg, n_rows, r_blk=8)] * B)
        np.testing.assert_array_equal(tplan.edge_perm.numpy(),
                                      np.asarray(jplan.edge_perm))
        np.testing.assert_array_equal(tplan.lrow.numpy(),
                                      np.asarray(jplan.lrow))
    want = JE.aggregate_batched(
        jnp.asarray(seg_b), n_rows, data_sum=jnp.asarray(dsum),
        data_max=jnp.asarray(dmax), data_or=jnp.asarray(dor), or_nbits=12,
        backend=jb, plan=jplan,
    )
    got = TE.aggregate_batched(
        torch.from_numpy(seg_b), n_rows, data_sum=torch.from_numpy(dsum),
        data_max=torch.from_numpy(dmax), data_or=torch.from_numpy(dor),
        or_nbits=12, backend=tb, plan=tplan,
    )
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape[:2] == (B, n_rows)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_plan_padding_and_stacking_match_reference():
    """pad_plan slots follow pack_blocks (edge 0, lrow = r_blk), so a padded
    plan reduces bit for bit as the original; stack_plans pads to the
    batch's (or the given) edge budget and repeats the last plan up to
    ``batch_multiple``, as the reference does."""
    jg, tg = jgen.gnm(40, 100, seed=5), tgen.gnm(40, 100, seed=5)
    jpg = jpartition(jg, 1, window_cap=8, common_cap=4)
    tpg = tpart.partition_graph(tg, 1, window_cap=8, common_cap=4)
    row = np.asarray(tpg.row[0])
    jplan = JE.build_plan(np.asarray(jpg.row[0]), jpg.V, r_blk=8)
    tplan = TE.build_plan(row, tpg.V, r_blk=8)
    eb = tplan.edge_perm.shape[1]
    jpad, tpad = JE.pad_plan(jplan, eb + 24), TE.pad_plan(tplan, eb + 24)
    np.testing.assert_array_equal(tpad.edge_perm.numpy(),
                                  np.asarray(jpad.edge_perm))
    np.testing.assert_array_equal(tpad.lrow.numpy(), np.asarray(jpad.lrow))
    data = torch.from_numpy(
        np.random.default_rng(0).integers(0, 100, row.shape[0])
        .astype(np.int32))
    s0 = TE.aggregate(None, tpg.V, data_sum=data, backend="blocked",
                      plan=tplan)[0]
    s1 = TE.aggregate(None, tpg.V, data_sum=data, backend="blocked",
                      plan=tpad)[0]
    assert torch.equal(s0, s1)
    with pytest.raises(ValueError, match="shrink"):
        TE.pad_plan(tpad, eb)

    jst = JE.stack_plans([jplan] * 3, e_blk=eb + 8, batch_multiple=4)
    tst = TE.stack_plans([tplan] * 3, e_blk=eb + 8, batch_multiple=4)
    assert tst.edge_perm.shape == (4, tplan.edge_perm.shape[0], eb + 8)
    np.testing.assert_array_equal(tst.edge_perm.numpy(),
                                  np.asarray(jst.edge_perm))
    np.testing.assert_array_equal(tst.lrow.numpy(), np.asarray(jst.lrow))
    with pytest.raises(ValueError, match="batch_multiple"):
        TE.stack_plans([tplan], batch_multiple=0)
    with pytest.raises(ValueError, match="below batch requirement"):
        TE.stack_plans([tplan], e_blk=eb - 8)
    other = TE.build_plan(row, tpg.V, r_blk=16)
    with pytest.raises(ValueError, match="one serve cell"):
        TE.stack_plans([tplan, other])


# --------------------------------------------------------------------- #
# PlanCache and topology_hash
# --------------------------------------------------------------------- #


def test_plan_cache_lru_eviction_bound():
    c = TE.PlanCache(max_entries=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1       # refreshes recency: b is now oldest
    c.put("c", 3)                # evicts b
    assert len(c) == 2 and "b" not in c
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    s = c.stats
    assert s.evictions == 1 and s.size == 2
    with pytest.raises(ValueError, match="max_entries"):
        TE.PlanCache(max_entries=0)


def test_plan_cache_raising_build_does_not_poison():
    c = TE.PlanCache(max_entries=4)
    calls = [0]

    def bad():
        calls[0] += 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        c.get_or_build("k", bad)
    s = c.stats
    assert len(c) == 0 and s.misses == 1 and s.errors == 1 and s.hits == 0
    assert c.get_or_build("k", lambda: 42) == 42   # retry rebuilds
    assert c.get_or_build("k", bad, tag="descent") == 42
    assert calls[0] == 1
    s = c.stats
    assert s.errors == 1 and s.hits == 1 and s.misses == 2
    assert (s.descent_hits, s.descent_misses) == (1, 0)


def test_topology_hash_matches_reference():
    g = tgen.gnm(30, 60, seed=0)
    row, col = g.edge_sources(), g.indices
    h0 = TE.topology_hash(row, col, g.n)
    assert h0 == JE.topology_hash(row, col, g.n)
    perm = np.random.default_rng(0).permutation(row.shape[0])
    assert TE.topology_hash(row[perm], col[perm], g.n) == h0
    keep = ~(((row == row[0]) & (col == col[0]))
             | ((row == col[0]) & (col == row[0])))
    assert TE.topology_hash(row[keep], col[keep], g.n) != h0
    assert TE.topology_hash(row, col, g.n + 1) != h0


def test_plan_for_caches_by_topology():
    cache = TE.PlanCache()
    g = tgen.gnm(30, 60, seed=1)
    row, col = g.edge_sources(), g.indices
    p1 = TE.plan_for(cache, row, g.n, r_blk=8, col=col)
    p2 = TE.plan_for(cache, row, g.n, r_blk=8, col=col, tag="descent")
    assert p1 is p2
    assert (cache.stats.hits, cache.stats.misses) == (1, 1)
    assert cache.stats.descent_hits == 1
    p3 = TE.plan_for(None, row, g.n, r_blk=8)
    assert torch.equal(p3.edge_perm, p1.edge_perm)


def test_service_cache_hits_and_eviction_bound():
    svc = _tsvc(algo="rg")
    g = tgen.gnm(24, 50, seed=1)
    first = svc.solve_one(g)
    again = svc.solve_one(g)                     # identical topology: hit
    w = np.random.default_rng(7).integers(1, 201, size=g.n).astype(np.int32)
    svc.solve_one(type(g)(indptr=g.indptr, indices=g.indices, weights=w))
    st = svc.stats
    assert (st["cache_misses"], st["cache_hits"]) == (1, 2)
    assert np.array_equal(first.members, again.members)
    svc.solve_one(tgen.gnm(24, 51, seed=1))      # edge change: miss
    assert svc.stats["cache_misses"] == 2
    small = _tsvc(algo="rg", cache_entries=2)
    for s in range(4):
        small.solve_one(tgen.gnm(20, 40, seed=s))
    assert small.stats["cache_size"] <= 2
    assert small.stats["cache_evictions"] == 2


# --------------------------------------------------------------------- #
# bucketing and admission
# --------------------------------------------------------------------- #


def test_cells_match_reference():
    """The reference's cells, field for field, its multi-device knobs
    (serve_devices, pipeline) included."""
    assert TSV.ServeCell._fields == JSV.ServeCell._fields
    assert TSV.serve_cells() == tuple(
        TSV.ServeCell(*c) for c in JSV.serve_cells())
    assert TSV.descent_entry_cells() == tuple(
        TSV.ServeCell(*c) for c in JSV.descent_entry_cells())


@pytest.mark.parametrize("name", ["serve_xs", "serve_s", "serve_m",
                                  "descent_l", "descent_xl"])
def test_config_rows_match_reference(name):
    """The port's copy of the serve / descent shape rows and helpers is the
    reference's."""
    from repro.configs import base as jbase
    from repro.configs import mwis as jcfg
    from repro_torch.configs import mwis as tcfg

    assert tcfg.MWIS_SHAPES[name] == jbase.MWIS_SHAPES[name]
    assert tcfg.rule_schedule(name) == jcfg.rule_schedule(name)
    assert tcfg.serve_knobs(name) == jcfg.serve_knobs(name)
    assert tcfg.MWIS_SERVE_BATCH_SIZES == jbase.MWIS_SERVE_BATCH_SIZES
    assert tcfg.serve_cell_names() == jcfg.serve_cell_names()


@pytest.mark.parametrize("n,m", [(10, 20), (64, 8), (65, 8), (8, 1026),
                                 (256, 4096), (1024, 16384), (1025, 4),
                                 (4, 16386)])
def test_bucket_for_matches_reference(n, m):
    try:
        want = JSV.bucket_for(n, m).name
    except ValueError as e:
        assert "exceeds every serve cell" in str(e)
        with pytest.raises(ValueError, match="exceeds every serve cell"):
            TSV.bucket_for(n, m)
    else:
        assert TSV.bucket_for(n, m).name == want


def test_oversize_is_rejected_naming_the_distributed_path():
    svc = _tsvc()
    big = svc.cells[-1].L + 1
    g = tgen.gnm(big, 10, seed=0)
    r = svc.solve_one(g)
    assert not r.ok and r.reason == TV.REASON_OVERSIZE
    assert "solvers.solve" in r.error and r.members.shape == (big,)
    assert svc.stats["rejected"] == 1


def test_poisoned_batchmates_are_isolated():
    """Rejected and repaired requests among healthy ones: the same reason
    codes as the reference, and the healthy ones solve as if alone."""
    good = _requests(tgen, [(20, 40), (25, 50), (30, 60)], 1, seed=70)
    nan_g = TGraph(indptr=np.array([0, 1, 2]),
                   indices=np.array([1, 0], np.int32),
                   weights=np.array([np.nan, 1.0]))
    bad_idx = TGraph(indptr=np.array([0, 1, 2]),
                     indices=np.array([5, 0], np.int32),
                     weights=np.array([1, 2], np.int32))
    loop_g = TGraph(indptr=np.array([0, 2, 3, 3]),
                    indices=np.array([0, 1, 0], np.int32),
                    weights=np.array([7, 3, 9], np.int32))
    empty = TGraph(indptr=np.zeros(1, np.int64),
                   indices=np.zeros(0, np.int32),
                   weights=np.zeros(0, np.int32))
    batch = [good[0], nan_g, good[1], bad_idx, loop_g, empty, good[2]]
    svc = _tsvc(max_batch=4, verify="full")
    res = svc.solve_batch(batch)

    want = JSV.MWISService(JSV.ServeConfig(
        backend="jnp", max_batch=4, verify="full", pipeline=False,
    )).solve_batch([JGraph(indptr=g.indptr, indices=g.indices,
                           weights=g.weights) for g in batch])
    _same(res, want, "poisoned batch")
    assert res[1].reason == TV.REASON_BAD_WEIGHT == JV.REASON_BAD_WEIGHT
    assert res[3].reason == TV.REASON_BAD_INDEX
    assert res[4].ok and res[4].weight == 9 + 7
    assert res[5].ok and res[5].members.shape == (0,)
    alone = _tsvc(verify="full").solve_batch(good)
    _same([res[0], res[2], res[6]], alone, "healthy batchmates")
    st = svc.stats
    assert st["rejected"] == 2 and st["repaired"] == 1
    assert st["verify_failures"] == 0 and st["verify_checked"] >= 4


def test_pack_failure_is_isolated(monkeypatch):
    good = _requests(tgen, [(20, 40), (22, 44)], 1, seed=9)
    real = TSV._pack_topology

    def flaky(g, cell, backend, device):
        if g.n == 22:
            raise RuntimeError("injected pack failure")
        return real(g, cell, backend, device)

    monkeypatch.setattr(TSV, "_pack_topology", flaky)
    svc = _tsvc()
    res = svc.solve_batch(good)
    assert res[0].ok and not res[1].ok
    assert res[1].reason == TV.REASON_PACK_FAILED
    assert svc.stats["pack_errors"] == 1 and svc.stats["cache_errors"] == 1


# --------------------------------------------------------------------- #
# backend fallback chain (through the _execute_chunk seam)
# --------------------------------------------------------------------- #


def test_backend_fallback_chain_recovers():
    """``blocked`` falls to ``torch`` (both plain PyTorch, bit-identical);
    the demotion is counted, logged and sticks."""
    svc = _tsvc(backend="blocked", verify="full")
    real = TSV.MWISService._execute_chunk
    seen = []

    def flaky(self, cell, topos, backend):
        seen.append(backend)
        if backend != "torch":
            raise RuntimeError(f"injected {backend} failure")
        return real(self, cell, topos, backend)

    svc._execute_chunk = flaky.__get__(svc)
    g = tgen.gnm(20, 40, seed=0)
    r = svc.solve_one(g)
    assert r.ok and TV.verify_result(g, r.members, r.weight).ok
    np.testing.assert_array_equal(r.members, _single(g, "rg", "torch"))
    st = svc.stats
    assert seen == ["blocked", "torch"]
    assert st["backend"] == "blocked" and st["backend_active"] == "torch"
    assert st["fallbacks"] == 1 and st["solve_errors"] == 0
    assert [e[:3] for e in svc.events] == [("fallback", "blocked", "torch")]
    r2 = svc.solve_one(tgen.gnm(20, 40, seed=1))   # the demotion sticks
    assert r2.ok and svc.stats["fallbacks"] == 1 and seen[-1] == "torch"


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_exhausted_fallback_chain_degrades_to_error(backend):
    """``torch`` ends the chain and ``cuda`` (the kernel) has none: a
    failure gives backend_failed results, never the plain version."""
    svc = _tsvc(backend=backend)
    seen = []

    def broken(self, cell, topos, backend):
        seen.append(backend)
        raise RuntimeError("injected total failure")

    svc._execute_chunk = broken.__get__(svc)
    r = svc.solve_one(tgen.gnm(20, 40, seed=0))
    assert not r.ok and r.reason == TV.REASON_BACKEND_FAILED
    assert seen == [backend]
    assert svc.stats["solve_errors"] == 1 and svc.stats["fallbacks"] == 0
    assert svc.stats["backend_active"] == backend


def test_kernel_failure_is_not_hidden(monkeypatch):
    """A ``segment_fused`` kernel that raises (as a failed build or launch
    does on the card) fails the chunk's requests on ``cuda``; nothing
    reruns them on a plain backend."""
    from repro_torch.core import engine

    def broken(*a, **kw):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(engine, "segment_fused_coo", broken)
    svc = _tsvc(backend="cuda")
    reqs = _requests(tgen, [(20, 40), (24, 48)], 1)
    res = svc.solve_batch(reqs)
    assert all(not r.ok and r.reason == TV.REASON_BACKEND_FAILED
               for r in res)
    assert "injected kernel failure" in res[0].error
    st = svc.stats
    assert st["fallbacks"] == 0 and st["backend_active"] == "cuda"


# --------------------------------------------------------------------- #
# configuration and statistics
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kw", [dict(algo="reduce"), dict(backend="pallas"),
                                dict(verify="all"), dict(descent="on"),
                                dict(devices=0)])
def test_bad_config_raises(kw):
    with pytest.raises(ValueError):
        _tsvc(**kw)


def test_stage_stats_have_the_reference_keys():
    """The default service pipelines, as the reference's does."""
    svc = _tsvc(max_batch=2)
    svc.solve_batch(_requests(tgen, [(18, 40), (20, 44), (22, 48)], 1))
    got = svc.stats
    ref = JSV.MWISService(JSV.ServeConfig()).stats
    assert set(got) == set(ref)
    assert got["chunks"] == 2 and got["devices"] == 1 == ref["devices"]
    assert got["pipeline"] is True is ref["pipeline"]
    assert got["pipelined_chunks"] == 2
    assert got["stage_ms"]["solve"] > 0 and got["wall_ms"] > 0
    assert set(got["stage_p50_ms"]) == {"pack", "transfer", "solve",
                                        "fetch"}


def test_measure_throughput_counts_instances():
    svc = _tsvc(algo="greedy", max_batch=4)
    reqs = _requests(tgen, [(20, 40), (30, 60)], 3)
    st = TSV.measure_throughput(svc, [reqs[:4], reqs[4:]], warmup=1)
    assert st["instances"] == 6 and st["batches"] == 2
    assert st["instances_per_sec"] > 0 and st["p99_ms"] >= st["p50_ms"]
    assert st["max_ms"] >= st["p99_ms"]
    assert svc.stats["cache_misses"] == 2


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #


def _lines(text):
    """The printed lines with the host-clock numbers (times and the
    overlap ratio made of them) and the backend / device / pipeline names
    taken out."""
    text = re.sub(r"throughput=[0-9.]+", "throughput=T", text)
    text = re.sub(r"p50=[0-9.]+ms p99=[0-9.]+ms", "p50=P p99=P", text)
    text = re.sub(r"(pack|transfer|solve|fetch)=[0-9.]+ms", r"\1=S", text)
    text = re.sub(r"overlap_ratio=[0-9.]+", "overlap_ratio=R", text)
    text = re.sub(r"backend=\w+", "backend=B", text)
    return [ln for ln in text.splitlines()
            if ln.strip() and not ln.startswith("devices:")]


def test_cli_prints_reference_lines(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` in a subprocess
    prints the reference CLI's lines for the same stream (times, backend
    names and the devices line aside)."""
    args = ["--arch", "mwis", "--requests", "4", "--batch", "4",
            "--repeat-topologies", "2", "--seed", "3"]
    jlaunch.main(args)
    want = _lines(capsys.readouterr().out)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--device", "cpu", "--backend", "cuda"],
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "devices: 1/1 visible (cpu) pipeline=on" in res.stdout
    got = _lines(res.stdout)
    assert got == want
    assert len(got) == 9


def test_cli_without_a_gpu_refuses_to_run():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "4"],
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
