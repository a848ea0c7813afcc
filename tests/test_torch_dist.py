"""Port parity of the per-PE path: DisRedu and the solvers on one spawned
rank of a gloo process group a PE (CPU tensors: the ``cuda`` backend takes
the kernel's plain version), against the port's union path and the
reference's, and directly against the reference's shard_map functions.
Exact equality: every payload is int32 / int8.

The sweeps inside a round are rank-local on the per-PE path, as in the
reference, so on some instances its round count, and even its reduced
graph, differ from the union path's: the ``LOCAL`` instance shows it, and
there every output is held against the reference's own shard_map run.

The ranks are spawned once for the module (``run_shard_map`` runs every
config on them), and their rendezvous and hand-off files live under the
module's temporary directory.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import engine as JE
from repro.core import exchange as JX
from repro.core import partition as jpart
from repro.core import solvers as JS
from repro.graphs import generators as jgen
from repro.kernels.segment_coo.ops import (
    pack_blocks_stacked as j_pack_blocks_stacked,
)
from repro_torch import convert
from repro_torch.core import distributed as TD
from repro_torch.core import engine as TE
from repro_torch.core import partition as tpart
from repro_torch.core import solvers as TS
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.segment_coo.ops import pack_blocks_stacked
from repro_torch.launch import mesh
from repro_torch.launch import mwis_run

SRC = Path(__file__).resolve().parents[1] / "src"
P, N, WINDOW_CAP, HEAVY_K = 4, 400, 8, 6
#: (n, window_cap, heavy_k, seed) of an instance where the per-PE path's
#: rounds, statuses and offset differ from the union path's (DisReduA, a2a)
LOCAL = (2000, 16, 8, 7)

REDUCE = [(mode, exchange) for mode in ("sync", "async")
          for exchange in ("allgather", "a2a")]
#: (algo, mode, exchange, schedule) of the solver runs
SOLVE = [("rg", "async", "allgather", "edges-only"),
         ("rnp", "sync", "a2a", "cheap")]


def _reduce_cfg(mode, exchange, backend="cuda"):
    return dict(heavy_k=HEAVY_K, mode=mode, exchange=exchange,
                schedule="cheap-fused", backend=backend)


def _local_cfg(backend="cuda"):
    return dict(heavy_k=LOCAL[2], mode="async", exchange="a2a",
                schedule="cheap-fused", backend=backend)


def _solve_cfg(mode, exchange, schedule, backend="cuda"):
    return dict(heavy_k=HEAVY_K, mode=mode, exchange=exchange,
                schedule=schedule, backend=backend)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so torch's pool does not fight JAX's (and the
    other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The same instance partitioned by the reference and by the port."""
    jg, tg = jgen.rgg2d(N, avg_deg=7, seed=5), tgen.rgg2d(N, avg_deg=7, seed=5)
    return (jpart.partition_graph(jg, P, window_cap=WINDOW_CAP),
            tg, tpart.partition_graph(tg, P, window_cap=WINDOW_CAP))


@pytest.fixture(scope="module")
def local_pair():
    """The ``LOCAL`` instance partitioned by the reference and the port."""
    n, window_cap, _, seed = LOCAL
    return (jpart.partition_graph(jgen.rgg2d(n, avg_deg=7, seed=seed), P,
                                  window_cap=window_cap),
            tpart.partition_graph(tgen.rgg2d(n, avg_deg=7, seed=seed), P,
                                  window_cap=window_cap))


@pytest.fixture(scope="module")
def dist(pair, local_pair, tmp_path_factory):
    """Every config of this module on 4 gloo ranks, spawned once:
    {("reduce", mode, exchange) | (algo,) | ("local",): stacked per-PE
    outputs}."""
    _, _, tpg = pair
    keys, jobs = [], []
    for mode, exchange in REDUCE:
        keys.append(("reduce", mode, exchange))
        jobs.append(mesh.PEJob("reduce", TD.DisReduConfig(
            **_reduce_cfg(mode, exchange))))
    for algo, mode, exchange, schedule in SOLVE:
        keys.append((algo,))
        jobs.append(mesh.PEJob(algo, TD.DisReduConfig(
            **_solve_cfg(mode, exchange, schedule))))
    keys.append(("local",))
    jobs.append(mesh.PEJob("reduce", TD.DisReduConfig(**_local_cfg()),
                           part=1))
    outs, stats = mesh.run_shard_map(
        [tpg, local_pair[1]], jobs, backend="gloo", device="cpu",
        directory=str(tmp_path_factory.mktemp("pe_arrays")))
    assert stats["handoff_seconds"] >= 0 and stats["spawn_seconds"] > 0
    return dict(zip(keys, outs))


def _assert_pe_state(out, state, p, label):
    """Per-PE outputs [p, ...] == a union state reshaped to [p, V]."""
    V = state.w.shape[0] // p
    np.testing.assert_array_equal(out["status"],
                                  np.asarray(state.status).reshape(p, V),
                                  err_msg=f"{label}: status")
    np.testing.assert_array_equal(out["w"], np.asarray(state.w).reshape(p, V),
                                  err_msg=f"{label}: w")
    total = int(out["offset"].astype(np.int64).sum())
    assert np.int32(total) == np.int32(np.asarray(state.offset)), label


def _split_union_log(state, p):
    """A union state's fold log in the per-PE layout: ``log_kind`` /
    ``log_v`` / ``log_u`` [p, V+1] and ``log_n`` [p], PE i's records in
    union order with local indices (every record's vertices lie in its
    PE's block), zero past its count."""
    V = state.w.shape[0] // p
    n = int(state.log_n)
    kind, v, u = (getattr(state, f)[:n].numpy()
                  for f in ("log_kind", "log_v", "log_u"))
    pe = v // V
    out = {k: np.zeros((p, V + 1), dtype=x.dtype)
           for k, x in (("log_kind", kind), ("log_v", v), ("log_u", u))}
    out["log_n"] = np.bincount(pe, minlength=p).astype(np.int32)
    for i in range(p):
        sel = pe == i
        k = int(sel.sum())
        out["log_kind"][i, :k] = kind[sel]
        out["log_v"][i, :k] = v[sel] - i * V
        out["log_u"][i, :k] = u[sel] - i * V
    return out


@pytest.mark.parametrize("mode,exchange", REDUCE)
def test_dist_reduce_matches_union_and_reference(pair, dist, mode, exchange):
    jpg, _, tpg = pair
    out = dist[("reduce", mode, exchange)]
    label = f"reduce/{mode}/{exchange}"
    ts, _, trounds = TD.disredu(tpg, TD.DisReduConfig(
        **_reduce_cfg(mode, exchange)), device="cpu")
    js, _, jrounds = JD.disredu(jpg, JD.DisReduConfig(
        **_reduce_cfg(mode, exchange, backend="blocked")))
    for name, state, rounds in (("port union", ts, trounds),
                                ("reference union", js, jrounds)):
        _assert_pe_state(out, state, P, f"{label} vs {name}")
        logs = _split_union_log(convert.red_state(state), P)
        for k, v in logs.items():
            np.testing.assert_array_equal(out[k], v,
                                          err_msg=f"{label} vs {name}: {k}")
    # one round count: the round's flag is ORed over the ranks
    assert (out["rounds"] == out["rounds"][0]).all(), out["rounds"]
    launches = out["launches"]
    assert all((launches[k] == 0).all() for k in launches), launches


@pytest.mark.parametrize("union", ["port", "reference"])
def test_dist_reduce_sweeps_are_rank_local(local_pair, dist, union):
    """On the ``LOCAL`` instance a PE's cheap rules go quiet before the
    others', and its rank-local sweeps run heavy vertex while the union's
    global flag still holds it back: the per-PE run ends in fewer rounds
    on another reduced graph (statuses and offset differ) than the union
    path, the port's or the reference's.  The reference's shard_map ends
    on the per-PE run's bits (``test_dist_matches_reference_shard_map``):
    this is the reference's algorithm, not a fault of the port."""
    jpg, tpg = local_pair
    out = dist[("local",)]
    if union == "port":
        state, _, rounds = TD.disredu(tpg, TD.DisReduConfig(**_local_cfg()),
                                      device="cpu")
    else:
        state, _, rounds = JD.disredu(jpg, JD.DisReduConfig(
            **_local_cfg(backend="blocked")))
    V = out["status"].shape[1]
    assert (out["rounds"] == out["rounds"][0]).all(), out["rounds"]
    assert out["rounds"][0] < rounds, (out["rounds"], rounds)
    assert not np.array_equal(out["status"],
                              np.asarray(state.status).reshape(P, V))
    total = np.int32(out["offset"].astype(np.int64).sum())
    assert total != np.int32(np.asarray(state.offset))


@pytest.mark.parametrize("algo,mode,exchange,schedule", SOLVE)
def test_dist_solver_matches_union_and_reference(pair, dist, algo, mode,
                                                 exchange, schedule):
    jpg, tg, tpg = pair
    out = dist[(algo,)]
    members = TD.members_global_per_pe(tpg, out["members"])
    assert tg.is_independent_set(members)
    tm, ts = TS.solve(tpg, algo, TD.DisReduConfig(
        **_solve_cfg(mode, exchange, schedule)), device="cpu")
    jm, js = JS.solve(jpg, algo, JD.DisReduConfig(
        **_solve_cfg(mode, exchange, schedule, backend="blocked")))
    np.testing.assert_array_equal(members, tm)
    np.testing.assert_array_equal(members, np.asarray(jm))
    _assert_pe_state(out, ts, P, f"{algo} vs port union")
    _assert_pe_state(out, js, P, f"{algo} vs reference union")


REFERENCE_SHARD_MAP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.core import distributed as D, partition as part, solvers as S
    from repro.graphs import generators as gen
    from repro.launch.mesh import make_host_mesh

    mesh = make_host_mesh({p})
    out = {{}}
    for tag, n, window_cap, heavy_k, seed in (
            ("reduce", {n}, {window_cap}, {heavy_k}, 5), ("local", *{local})):
        g = gen.rgg2d(n, avg_deg=7, seed=seed)
        pg = part.partition_graph(g, {p}, window_cap=window_cap)
        cfg = D.DisReduConfig(heavy_k=heavy_k, mode="async",
                              exchange="a2a", schedule="cheap-fused",
                              backend="blocked")
        run, _ = D.disredu_shard_map_fn(pg, cfg, mesh)
        for k, v in zip(("w", "status", "log_kind", "log_v", "log_u",
                         "log_n", "offset", "rounds"), run()):
            out[tag + "_" + k] = np.asarray(v)
    g = gen.rgg2d({n}, avg_deg=7, seed=5)
    pg = part.partition_graph(g, {p}, window_cap={window_cap})
    cfg = D.DisReduConfig(heavy_k={heavy_k}, mode="sync", exchange="a2a",
                          backend="blocked")
    run, _ = S.solver_shard_map_fn(pg, cfg, mesh, "rnp")
    for k, v in zip(("w", "status", "members", "offset", "log_n"), run()):
        out["rnp_" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""").format(n=N, p=P, window_cap=WINDOW_CAP, heavy_k=HEAVY_K,
             local=LOCAL)


@pytest.mark.slow
def test_dist_matches_reference_shard_map(dist, tmp_path):
    """The reference's own shard_map functions (4 host devices, a
    subprocess) against the port's per-PE path, rank for rank: DisReduA
    with the a2a exchange (rounds included, also on the ``LOCAL`` instance,
    where both end on another reduced graph than the union path), and rnp
    with the a2a exchange."""
    path = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE_SHARD_MAP, str(path)], env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = np.load(path)
    for tag, out in (("reduce", dist[("reduce", "async", "a2a")]),
                     ("local", dist[("local",)])):
        for k in ("w", "status", "log_kind", "log_v", "log_u", "log_n",
                  "offset", "rounds"):
            np.testing.assert_array_equal(out[k], ref[tag + "_" + k],
                                          err_msg=f"{tag}: {k}")
    rnp = dist[("rnp",)]
    for k in ("w", "status", "members", "offset", "log_n"):
        np.testing.assert_array_equal(rnp[k], ref["rnp_" + k],
                                      err_msg=f"rnp: {k}")


@pytest.mark.parametrize("r_blk", [8, None])
def test_build_plan_stacked_matches_reference(pair, r_blk):
    jpg, _, tpg = pair
    want = convert.seg_plan(JE.build_plan_stacked(
        jpg.row, jpg.V, r_blk=r_blk, cols=jpg.col, gids=jpg.gid,
        windows=jpg.window, win_adj_bits=jpg.win_adj_bits))
    got = TE.build_plan_stacked(
        tpg.row, tpg.V, r_blk=r_blk, cols=tpg.col, gids=tpg.gid,
        windows=tpg.window, win_adj_bits=tpg.win_adj_bits)
    assert got.r_blk == want.r_blk
    assert got.extent.shape == got.edge_perm.shape[:2]
    for f in ("edge_perm", "lrow", "extent", "wbits", "wnh"):
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # rank i's plan is row i of each field: the PE's own plan, padded
    for i in range(P):
        own = TE.build_plan(tpg.row[i], tpg.V, r_blk=got.r_blk,
                            col=tpg.col[i], gid=tpg.gid[i],
                            window=tpg.window[i],
                            win_adj_bits=tpg.win_adj_bits[i])
        padded = TE.pad_plan(own, got.edge_perm.shape[-1])
        for f in ("edge_perm", "lrow", "extent"):
            assert torch.equal(getattr(got, f)[i], getattr(padded, f)), f
        assert torch.equal(got.wbits[i], own.wbits)


def test_pack_blocks_stacked_matches_reference(pair):
    _, _, tpg = pair
    got = pack_blocks_stacked(tpg.row, tpg.V, r_blk=16, e_blk_multiple=8)
    want = j_pack_blocks_stacked(tpg.row, tpg.V, r_blk=16, e_blk_multiple=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_shard_map_arrays_match_reference(pair, backend):
    jpg, _, tpg = pair
    got = TD.shard_map_arrays(tpg, TD.DisReduConfig(backend=backend))
    want = JD.shard_map_arrays(jpg, JD.DisReduConfig(
        backend="jnp" if backend == "torch" else "blocked"))
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_unpack_per_pe_halo_is_the_per_pe_layout(pair):
    """Rank i's halo: the reference's per-PE ``make_halo(pg, pe=i)``."""
    jpg, _, tpg = pair
    arrs = TD.shard_map_arrays(tpg, TD.DisReduConfig(backend="cuda"))
    for i in range(P):
        _, halo, plan, _ = TD._unpack_per_pe(
            {k: v[i] for k, v in arrs.items()}, "cpu")
        want = convert.halo(JX.make_halo(jpg, pe=i))
        for f in halo._fields:
            np.testing.assert_array_equal(getattr(halo, f).numpy(),
                                          getattr(want, f).numpy(),
                                          err_msg=f"pe {i}: {f}")
        assert plan.edge_perm.dim() == 2 and plan.wbits.dim() == 1


def test_nccl_needs_one_card_a_rank():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="NCCL needs one CUDA card a rank"):
        mesh.spawn_pes(mesh.shard_map_rank, cards + 1, backend="nccl",
                       device="cpu")
    with pytest.raises(ValueError, match="unknown process-group backend"):
        mesh.check_backend("mpi", 2)


def test_a_failing_rank_fails_the_run(pair, tmp_path):
    _, _, tpg = pair
    with pytest.raises(RuntimeError, match=r"rank \d failed"):
        mesh.run_shard_map([tpg], [mesh.PEJob("bogus", TD.DisReduConfig())],
                         device="cpu", directory=str(tmp_path))


def test_exchange_flag_reaches_the_config():
    ap = mwis_run.build_parser()
    assert mwis_run.config(ap.parse_args([])).exchange == "allgather"
    assert mwis_run.config(
        ap.parse_args(["--exchange", "a2a"])).exchange == "a2a"
