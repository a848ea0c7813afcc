"""Port parity of shape descent: ``repro_torch.core.solvers.solve_staged``,
``partition.compact_partition``, ``distributed.kernel_shape`` /
``ghosts_consistent`` and the service's ``descent="auto"`` path against
``repro.core`` on the same numpy-made instances, exactly (members,
descents, path, compacted partitions, checkpoint metadata, served results).
Inside the port: the staged solve equals the monolithic ``solve`` bit for
bit, with descent on and off.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import engine as JE
from repro.core import partition as jpart
from repro.core import serve as JSV
from repro.core import solvers as JS
from repro.core import validate as JV
from repro.distributed.checkpoint import CheckpointManager as JCheckpoint
from repro.graphs import generators as jgen
from repro.launch import serve as jlaunch
from repro_torch.core import distributed as TD
from repro_torch.core import engine as TE
from repro_torch.core import partition as tpart
from repro_torch.core import rules as TR
from repro_torch.core import serve as TSV
from repro_torch.core import solvers as TS
from repro_torch.core import validate as TV
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import InjectedFault
from repro_torch.graphs import generators as tgen

from _torch_jax import _release_jax_programs  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"

#: Tiny ladder so descents trigger on test-sized graphs (the reference
#: tests' own).
TINY = tuple(
    TS.LadderCell(name=f"t{L}", L=L, E=E, G=max(L // 2, 4),
                  B=max(L // 4, 4), S=max(L // 4, 4))
    for L, E in ((8, 128), (16, 256), (32, 512), (64, 1024), (128, 2048))
)
JTINY = tuple(JS.LadderCell(*c) for c in TINY)
#: reference backend → the port's backend computing the same function
JBACKEND = {"torch": "jnp", "blocked": "blocked", "cuda": "blocked"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(backend="torch", mode="async", **kw):
    """(reference, port) configs with descent on."""
    base = dict(mode=mode, heavy_k=6, descent=True, descent_every=2, **kw)
    return (JD.DisReduConfig(backend=JBACKEND[backend], **base),
            TD.DisReduConfig(backend=backend, **base))


def _graphs(gen_name, n, seed, **kw):
    return (getattr(jgen, gen_name)(n, seed=seed, **kw),
            getattr(tgen, gen_name)(n, seed=seed, **kw))


# --------------------------------------------------------------------- #
# kernel_shape / ghosts_consistent / compact_partition
# --------------------------------------------------------------------- #


def _mid_solve(p, rounds, seed=3):
    """The same RGG partitioned by both packages, and the reference's
    state after ``rounds`` DisRedu rounds (a post-exchange boundary)."""
    jg, tg = _graphs("rgg2d", 300, seed, avg_deg=8)
    jpg = jpart.partition_graph(jg, p, window_cap=12)
    tpg = tpart.partition_graph(tg, p, window_cap=12)
    js, _, _ = JD.disredu(jpg, JD.DisReduConfig(heavy_k=6, mode="async",
                                                max_rounds=rounds))
    return jpg, tpg, np.asarray(js.status), np.asarray(js.w)


def _assert_pg_equal(got, want, label):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {f.name}")
            assert a.dtype == b.dtype, f"{label}: {f.name} dtype"
        else:
            assert a == b, f"{label}: {f.name}"


@pytest.mark.parametrize("p,rounds", [(1, 2), (2, 1), (4, 3), (4, 40)])
def test_compact_partition_matches_reference(p, rounds):
    jpg, tpg, status, w = _mid_solve(p, rounds)
    need = TD.kernel_shape(tpg, status)
    assert need == JD.kernel_shape(jpg, status)
    assert TD.ghosts_consistent(tpg, status)
    assert JD.ghosts_consistent(jpg, status)
    for pad in (None, dict(L=64, E=1024, G=32, B=16, S=16)):
        got = tpart.compact_partition(tpg, status, w, pad_to=pad)
        want = jpart.compact_partition(jpg, status, w, pad_to=pad)
        _assert_pg_equal(got, want, f"p={p} rounds={rounds} pad={pad}")
        assert got.L >= need["L"] and got.E >= need["E"]


def test_inconsistent_ghosts_are_refused_alike():
    """A ghost alive while its owner's copy is decided (the state between
    a peel and the next exchange): both packages say inconsistent and
    refuse to compact."""
    jpg, tpg, status, w = _mid_solve(2, 1)
    status = status.reshape(2, -1).copy()
    pe, slot = np.argwhere(tpg.is_ghost & (status == 0))[0]
    gid = tpg.gid[pe, slot]
    owner = tpg.owner_pe[pe, slot]
    status[owner, np.flatnonzero(tpg.gid[owner] == gid)[0]] = 2
    status = status.reshape(-1)
    assert not TD.ghosts_consistent(tpg, status)
    assert not JD.ghosts_consistent(jpg, status)
    with pytest.raises(ValueError, match="exchange-consistent"):
        tpart.compact_partition(tpg, status, w)
    with pytest.raises(ValueError, match="exchange-consistent"):
        jpart.compact_partition(jpg, status, w)


# --------------------------------------------------------------------- #
# residual weight gate: folded weights must fit int32, never wrap
# --------------------------------------------------------------------- #


def test_residual_weights_near_int32_max():
    w = np.array([0, 1, TV.I32_MAX], dtype=np.int64)
    out = TV.residual_weights(w)
    assert out.dtype == np.int32 and int(out[2]) == TV.I32_MAX
    np.testing.assert_array_equal(out, JV.residual_weights(w))
    for bad in (TV.I32_MAX + 1, -1):
        with pytest.raises(TV.InvalidInstance) as ei:
            TV.residual_weights(np.array([bad], dtype=np.int64))
        assert ei.value.reason == TV.REASON_BAD_WEIGHT == JV.REASON_BAD_WEIGHT


def test_compact_partition_rejects_overflowing_residual():
    jg, tg = _graphs("gnm", 24, 1, m=60)
    jpg = jpart.partition_graph(jg, 2, window_cap=8)
    tpg = tpart.partition_graph(tg, 2, window_cap=8)
    status = np.zeros(tpg.p * tpg.V, dtype=np.int8)  # everything alive
    w = np.zeros(tpg.p * tpg.V, dtype=np.int64)
    w[: tpg.V] = TV.I32_MAX  # at the limit: fine
    got = tpart.compact_partition(tpg, status, w)
    _assert_pg_equal(got, jpart.compact_partition(jpg, status, w), "limit")
    assert int(got.w0.max()) == TV.I32_MAX

    w[0] = TV.I32_MAX + 1  # one past: must raise, not wrap negative
    assert tpg.is_local[0, 0] or tpg.is_ghost[0, 0]
    with pytest.raises(TV.InvalidInstance) as ei:
        tpart.compact_partition(tpg, status, w)
    assert ei.value.reason == TV.REASON_BAD_WEIGHT
    with pytest.raises(JV.InvalidInstance):
        jpart.compact_partition(jpg, status, w)


# --------------------------------------------------------------------- #
# the staged solve against the reference and against the port's solve
# --------------------------------------------------------------------- #


def _staged_pair(jg, tg, p, algo, backend, mode, window_cap=12, **kw):
    jcfg, tcfg = _cfgs(backend, mode)
    jm, jst = JS.solve_staged(jg, p, algo, jcfg, window_cap=window_cap,
                              ladder=JTINY, **kw)
    tm, tst = TS.solve_staged(tg, p, algo, tcfg, window_cap=window_cap,
                              ladder=TINY, device="cpu", **kw)
    return (jm, jst), (tm, tst), tcfg


@pytest.mark.parametrize("algo", ["greedy", "rg", "rnp"])
@pytest.mark.parametrize("backend", ["torch", "blocked"])
def test_staged_matches_reference(algo, backend):
    jg, tg = _graphs("rgg2d", 500, 3, avg_deg=8)
    (jm, jst), (tm, tst), tcfg = _staged_pair(jg, tg, 4, algo, backend,
                                              "async")
    np.testing.assert_array_equal(tm, jm)
    assert tst["descents"] == jst["descents"] >= 1
    assert tst["path"] == jst["path"]
    assert tst["alive_final"] == jst["alive_final"] == 0
    assert tst["kernel_ratio"] == jst["kernel_ratio"]
    # inside the port: descent on == descent off == the monolithic solve
    pg = tpart.partition_graph(tg, 4, window_cap=12)
    off = dataclasses.replace(tcfg, descent=False)
    m_mono, _ = TS.solve(pg, algo, off, device="cpu")
    m_off, st_off = TS.solve_staged(tg, 4, algo, off, window_cap=12,
                                    device="cpu")
    np.testing.assert_array_equal(tm, m_mono)
    np.testing.assert_array_equal(m_off, m_mono)
    assert st_off["descents"] == 0
    assert tg.is_independent_set(tm)


@pytest.mark.parametrize("gen_name,kw", [("gnm", dict(m=1600)),
                                         ("rgg2d", dict(avg_deg=8))])
@pytest.mark.parametrize("seed,backend", [(0, "cuda"), (4, "torch")])
def test_staged_seeded_families_match_reference(gen_name, kw, seed,
                                                backend):
    jg, tg = _graphs(gen_name, 400, seed, **kw)
    (jm, jst), (tm, tst), _ = _staged_pair(jg, tg, 2, "rnp", backend,
                                           "async")
    np.testing.assert_array_equal(tm, jm)
    assert tst["path"] == jst["path"]


@pytest.mark.parametrize("algo", ["rg", "rnp"])
def test_staged_sync_multiple_descents_match_reference(algo):
    jg, tg = _graphs("rgg2d", 500, 7, avg_deg=8)
    (jm, jst), (tm, tst), tcfg = _staged_pair(jg, tg, 2, algo, "torch",
                                              "sync", window_cap=16)
    np.testing.assert_array_equal(tm, jm)
    assert tst["path"] == jst["path"]
    if algo == "rnp":
        assert tst["descents"] >= 2, tst["path"]
    Ls = [e["L"] for e in tst["path"]]
    assert all(a > b for a, b in zip(Ls, Ls[1:])), Ls
    pg = tpart.partition_graph(tg, 2)
    m_mono, _ = TS.solve(pg, algo, dataclasses.replace(tcfg, descent=False),
                         device="cpu")
    np.testing.assert_array_equal(tm, m_mono)


def test_staged_reduce_matches_reference():
    """algo='reduce' stops at the kernel: the stitched members of the
    decided part and the path agree."""
    jg, tg = _graphs("rgg2d", 400, 2, avg_deg=6)
    (jm, jst), (tm, tst), _ = _staged_pair(jg, tg, 2, "reduce", "torch",
                                           "async")
    np.testing.assert_array_equal(tm, jm)
    assert tst["path"] == jst["path"]
    assert tst["alive_final"] == jst["alive_final"]


def test_staged_trajectory_and_stage_counts():
    """Trajectory records match the reference's stage by stage (phase,
    shape, L, rounds, alive; times aside)."""
    jg, tg = _graphs("rgg2d", 400, 5, avg_deg=8)
    (_, jst), (_, tst), _ = _staged_pair(jg, tg, 2, "rg", "torch", "async",
                                         trajectory=True)
    keys = ("phase", "shape", "L", "rounds", "alive")
    want = [{k: s[k] for k in keys} for s in jst["stages"]]
    assert [{k: s[k] for k in keys} for s in tst["stages"]] == want
    assert tst["t_total"] >= tst["t_descend"] > 0


def test_pick_cell_matches_reference():
    need = dict(L=20, E=300, G=1, B=1, S=1)
    for cur_L, cur_E, factor in ((200, 3000, 2), (40, 3000, 2),
                                 (64, 512, 2), (300, 300, 1)):
        got = TS._pick_cell(TINY, need, cur_L, cur_E, factor)
        want = JS._pick_cell(JTINY, need, cur_L, cur_E, factor)
        assert (got is None and want is None) or tuple(got) == tuple(want)


def test_default_ladder_matches_reference():
    assert TS.default_ladder() == tuple(
        TS.LadderCell(*c) for c in JS.default_ladder())


# --------------------------------------------------------------------- #
# descent-tagged plan-cache counters
# --------------------------------------------------------------------- #


def test_descent_plans_hit_cache_on_repeat_solve():
    jg, tg = _graphs("rgg2d", 400, 5, avg_deg=8)
    jcfg, tcfg = _cfgs("blocked")
    jcache, tcache = JE.PlanCache(max_entries=32), TE.PlanCache(
        max_entries=32)
    runs = []
    for _ in range(2):
        jm, _ = JS.solve_staged(jg, 2, "rnp", jcfg, window_cap=12,
                                ladder=JTINY, plan_cache=jcache)
        tm, st = TS.solve_staged(tg, 2, "rnp", tcfg, window_cap=12,
                                 ladder=TINY, plan_cache=tcache,
                                 device="cpu")
        np.testing.assert_array_equal(tm, jm)
        runs.append((tm, st, tcache.stats))
    (m1, st1, s1), (m2, _, s2) = runs
    assert st1["descents"] >= 1
    np.testing.assert_array_equal(m1, m2)
    assert s2.descent_misses == s1.descent_misses, "rebuilt descent plans"
    assert s2.descent_hits >= st1["descents"]
    js, ts = jcache.stats, tcache.stats
    assert (ts.hits, ts.misses, ts.descent_hits, ts.descent_misses) == \
        (js.hits, js.misses, js.descent_hits, js.descent_misses)


# --------------------------------------------------------------------- #
# checkpoint + resume across a descent boundary
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("algo,mode,seed", [("rnp", "async", 9),
                                            ("rnp", "sync", 9),
                                            ("rg", "async", 5)])
def test_resume_across_descent_boundary(tmp_path, algo, mode, seed):
    jg, tg = _graphs("rgg2d", 400, seed, avg_deg=8)
    jcfg, tcfg = _cfgs("torch", mode)
    m_ref, st_ref = TS.solve_staged(tg, 2, algo, tcfg, window_cap=12,
                                    ladder=TINY, device="cpu")
    assert st_ref["descents"] >= 1

    def kill(descents, cell_name):
        raise InjectedFault(f"killed after descent {descents}")

    ck = CheckpointManager(str(tmp_path / "port"), async_write=False)
    jck = JCheckpoint(str(tmp_path / "ref"), async_write=False)
    with pytest.raises(InjectedFault):
        TS.solve_staged(tg, 2, algo, tcfg, window_cap=12, ladder=TINY,
                        ckpt=ck, on_descent=kill, device="cpu")
    with pytest.raises(InjectedFault):
        JS.solve_staged(jg, 2, algo, jcfg, window_cap=12, ladder=JTINY,
                        ckpt=jck, on_descent=kill)
    assert ck.latest_step() == jck.latest_step() == 1
    # the same boundary, described alike
    assert ck.manifest()["extra"] == jck.manifest()["extra"]
    assert ck.manifest()["extra"]["kind"] == "solve_staged"

    m_res, st_res = TS.solve_staged(tg, 2, algo, tcfg, window_cap=12,
                                    ladder=TINY, ckpt=ck, resume=True,
                                    device="cpu")
    np.testing.assert_array_equal(m_res, m_ref)
    assert st_res["path"] == st_ref["path"]
    assert st_res["descents"] == st_ref["descents"]
    jm, _ = JS.solve_staged(jg, 2, algo, jcfg, window_cap=12, ladder=JTINY,
                            ckpt=jck, resume=True)
    np.testing.assert_array_equal(m_res, jm)


def test_restore_staged_gives_the_level_of_each_checkpoint(tmp_path):
    """``restore_staged`` replays the compaction chain to the level each
    checkpoint was taken at: its partition has that level's path shape,
    and its state is the fresh state of the level."""
    _, tg = _graphs("rgg2d", 500, 7, avg_deg=8)
    _, tcfg = _cfgs("blocked", "sync")
    ck = CheckpointManager(str(tmp_path / "ck"), keep=10, async_write=False)
    _, st = TS.solve_staged(tg, 2, "rnp", tcfg, ladder=TINY, ckpt=ck,
                            device="cpu")
    assert ck.list_steps() == list(range(1, st["descents"] + 1))
    pg = tpart.partition_graph(tg, 2)
    prob = TD.build_union_problem(pg, "blocked", device="cpu")
    for step in ck.list_steps():
        frames, pg_k, prob_k, state, extra = TS.restore_staged(
            ck, pg, prob, tcfg, ladder=TINY, step=step, device="cpu")
        assert len(frames) == step == extra["descents"]
        level = st["path"][step]
        assert (pg_k.L, pg_k.E) == (level["L"], level["E"])
        fresh = TR.init_state(prob_k.w0, prob_k.is_local, prob_k.is_ghost)
        for f in fresh._fields:
            assert torch.equal(getattr(state, f), getattr(fresh, f)), f
        assert prob_k.plan is not None


# --------------------------------------------------------------------- #
# serving integration
# --------------------------------------------------------------------- #


def _services(**kw):
    backend = kw.pop("backend", "torch")
    jsvc = JSV.MWISService(JSV.ServeConfig(
        pipeline=False, backend=JBACKEND[backend], **kw))
    tsvc = TSV.MWISService(TSV.ServeConfig(backend=backend, device="cpu",
                                           **kw))
    return jsvc, tsvc


def _assert_same_results(tres, jres):
    assert len(tres) == len(jres)
    for i, (a, b) in enumerate(zip(tres, jres)):
        assert (a.ok, a.reason) == (b.ok, b.reason), i
        np.testing.assert_array_equal(a.members, b.members, err_msg=str(i))
        assert a.weight == b.weight, i


@pytest.mark.parametrize("algo,backend", [("rg", "torch"), ("rnp", "torch"),
                                          ("greedy", "cuda")])
def test_service_descent_auto_matches_reference(algo, backend):
    """serve_s requests through the staged path (descent_min_L 256), an
    oversize request through descent_l, and the small ones batched."""
    shapes = [(40, 80), (200, 700), (200, 700), (300, 900)]
    big = TSV.serve_cells()[-1].L + 200
    jreqs = [jgen.gnm(n, m, seed=s) for s, (n, m) in enumerate(shapes)]
    treqs = [tgen.gnm(n, m, seed=s) for s, (n, m) in enumerate(shapes)]
    jreqs.append(jgen.gnm(big, 2 * big, seed=2))
    treqs.append(tgen.gnm(big, 2 * big, seed=2))
    jsvc, tsvc = _services(algo=algo, backend=backend, verify="full",
                           descent="auto", descent_min_L=256)
    _assert_same_results(tsvc.solve_batch(treqs), jsvc.solve_batch(jreqs))
    js, ts = jsvc.stats, tsvc.stats
    for k in ("descent_solves", "descents", "oversize_admitted", "rejected",
              "verify_checked", "verify_failures", "cache_descent_hits",
              "cache_descent_misses"):
        assert ts[k] == js[k], k
    assert ts["descent_solves"] == 4 and ts["oversize_admitted"] == 1
    assert ts["descents"] >= 1 and ts["verify_failures"] == 0


def test_service_descent_auto_matches_descent_off():
    reqs = [tgen.gnm(200, 700, seed=s) for s in range(3)]
    off = TSV.MWISService(TSV.ServeConfig(algo="rg", verify="full",
                                          device="cpu"))
    on = TSV.MWISService(TSV.ServeConfig(algo="rg", verify="full",
                                         device="cpu", descent="auto",
                                         descent_min_L=256))
    for a, b in zip(off.solve_batch(reqs), on.solve_batch(reqs)):
        assert a.ok and b.ok
        np.testing.assert_array_equal(a.members, b.members)
        assert a.weight == b.weight
    assert on.stats["descent_solves"] == len(reqs)
    assert off.stats["descent_solves"] == 0


def test_service_oversize_beyond_descent_cells_is_rejected_alike():
    huge_n = max(c.L for c in TSV.descent_entry_cells()) + 1
    g = dict(indptr=np.zeros(huge_n + 1, np.int64),
             indices=np.zeros(0, np.int32),
             weights=np.ones(huge_n, np.int32))
    jsvc, tsvc = _services(descent="auto")
    r = tsvc.solve_one(TSV.Graph(**g))
    want = jsvc.solve_one(JSV.Graph(**g))
    assert not r.ok and r.reason == want.reason == TV.REASON_OVERSIZE
    assert tsvc.stats["rejected"] == jsvc.stats["rejected"] == 1
    assert tsvc.stats["oversize_admitted"] == 0


def test_service_oversize_without_descent_is_rejected():
    big = TSV.serve_cells()[-1].L + 200
    svc = TSV.MWISService(TSV.ServeConfig(algo="rg", device="cpu"))
    r = svc.solve_one(tgen.gnm(big, 2 * big, seed=2))
    assert not r.ok and r.reason == TV.REASON_OVERSIZE


def test_staged_kernel_failure_is_not_hidden(monkeypatch):
    """On the ``cuda`` backend a failing staged solve is a
    ``backend_failed`` result, not a demotion to a plain version."""
    svc = TSV.MWISService(TSV.ServeConfig(
        backend="cuda", device="cpu", descent="auto", descent_min_L=256))

    def broken(*a, **k):
        raise RuntimeError("injected segment_fused failure")

    monkeypatch.setattr(TS, "solve_staged", broken)
    r = svc.solve_one(tgen.gnm(200, 700, seed=0))
    assert not r.ok and r.reason == TV.REASON_BACKEND_FAILED
    st = svc.stats
    assert st["fallbacks"] == 0 and st["backend_active"] == "cuda"
    assert st["solve_errors"] == 1


def test_staged_blocked_failure_falls_back_to_torch(monkeypatch):
    svc = TSV.MWISService(TSV.ServeConfig(
        backend="blocked", device="cpu", verify="full", descent="auto",
        descent_min_L=256))
    real = TS.solve_staged

    def flaky(g, p, algo, cfg, **kw):
        if cfg.backend != "torch":
            raise RuntimeError("injected blocked failure")
        return real(g, p, algo, cfg, **kw)

    monkeypatch.setattr(TS, "solve_staged", flaky)
    g = tgen.gnm(200, 700, seed=0)
    r = svc.solve_one(g)
    assert r.ok and TV.verify_result(g, r.members, r.weight).ok
    st = svc.stats
    assert st["fallbacks"] == 1 and st["backend_active"] == "torch"


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #


def test_cli_descent_auto_prints_reference_lines(capsys):
    """``launch.serve --descent auto`` on the CPU prints the reference
    CLI's lines (times, backend names and the devices line aside),
    including real counts on its ``descent:`` line."""
    args = ["--arch", "mwis", "--requests", "6", "--batch", "4",
            "--repeat-topologies", "2", "--seed", "1", "--descent", "auto",
            "--algo", "greedy"]
    jlaunch.main(args)
    want = _lines(capsys.readouterr().out)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = _lines(res.stdout)
    assert got == want
    line = next(ln for ln in got if ln.startswith("descent:"))
    assert "mode=auto solves=6" in line, line


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
