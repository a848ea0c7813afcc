"""Port parity: DisReduS/DisReduA and the greedy / rg / rnp solvers on the
union path, against ``repro.core.{distributed,solvers}`` on the same
partitioned instance.  Exact equality of status, weights, offset, fold log,
rounds and member masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import partition as jpart
from repro.core import rules as JR
from repro.core import solvers as JS
from repro.graphs import generators as jgen
from repro_torch import convert
from repro_torch.core import distributed as TD
from repro_torch.core import exchange as TX
from repro_torch.core import partition as tpart
from repro_torch.core import sequential as tseq
from repro_torch.core import solvers as TS
from repro_torch.graphs import generators as tgen

from _torch_jax import _release_jax_programs  # noqa: F401

GRAPHS = {
    "rgg": lambda gen: gen.rgg2d(300, avg_deg=7, seed=1),
    "rhg": lambda gen: gen.rhg_like(300, avg_deg=6, seed=2),
    "gnm": lambda gen: gen.gnm(250, 750, seed=3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, p, window_cap=8):
    """The same instance partitioned by the reference and by the port."""
    jg, tg = GRAPHS[name](jgen), GRAPHS[name](tgen)
    return (jg, jpart.partition_graph(jg, p, window_cap=window_cap),
            tg, tpart.partition_graph(tg, p, window_cap=window_cap))


def _assert_state_equal(got, want, label):
    g, w = convert.to_numpy(got), convert.to_numpy(want)
    for k in ("w", "status", "log_kind", "log_v", "log_u", "log_n",
              "offset"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{label}: {k}")


@pytest.mark.parametrize("name,p,mode,schedule", [
    ("rgg", 2, "sync", "cheap"),
    ("rgg", 4, "async", "cheap-fused"),
    ("rhg", 1, "async", "cheap-fused"),
    ("rhg", 4, "sync", "edges-only"),
    ("gnm", 2, "async", "cheap"),
    ("gnm", 4, "sync", "light"),
])
def test_disredu_matches_reference(name, p, mode, schedule):
    _, jpg, _, tpg = _pair(name, p)
    jcfg = JD.DisReduConfig(heavy_k=6, mode=mode, schedule=schedule,
                            backend="blocked")
    js, jprob, jrounds = JD.disredu(jpg, jcfg)
    jmem = JD.members_global(jpg, js, jprob.aux)
    for backend in ("blocked", "cuda"):
        tcfg = TD.DisReduConfig(heavy_k=6, mode=mode, schedule=schedule,
                                backend=backend)
        ts, tprob, trounds = TD.disredu(tpg, tcfg, device="cpu")
        label = f"{name}/p={p}/{mode}/{schedule}/{backend}"
        assert trounds == jrounds, label
        _assert_state_equal(ts, js, label)
        np.testing.assert_array_equal(
            TD.members_global(tpg, ts, tprob.aux), jmem, err_msg=label)
        assert TD.kernel_stats(tpg, ts) == JD.kernel_stats(jpg, js)


def test_disredu_torch_backend_matches_pallas_interpret():
    """The port's scatter backend against the reference's Pallas kernel
    (interpret mode) on one small case."""
    _, jpg, _, tpg = _pair("rgg", 2)
    js, _, jrounds = JD.disredu(jpg, JD.DisReduConfig(
        mode="async", schedule="cheap-fused", backend="pallas"))
    ts, _, trounds = TD.disredu(tpg, TD.DisReduConfig(
        mode="async", schedule="cheap-fused", backend="torch"), device="cpu")
    assert trounds == jrounds
    _assert_state_equal(ts, js, "pallas/torch")


@pytest.mark.parametrize("name,p,mode,algo", [
    ("rgg", 2, "async", "rnp"),
    ("rgg", 4, "sync", "greedy"),
    ("rhg", 4, "sync", "rg"),
    ("rhg", 2, "async", "rnp"),
    ("gnm", 1, "sync", "rnp"),
    ("gnm", 2, "async", "rg"),
])
def test_solve_matches_reference(name, p, mode, algo):
    jg, jpg, tg, tpg = _pair(name, p)
    jcfg = JD.DisReduConfig(mode=mode, schedule="edges-only",
                            backend="blocked")
    jmem, js = JS.solve(jpg, algo, jcfg)
    tcfg = TD.DisReduConfig(mode=mode, schedule="edges-only",
                            backend="cuda")
    tmem, ts = TS.solve(tpg, algo, tcfg, device="cpu")
    label = f"{name}/p={p}/{mode}/{algo}"
    _assert_state_equal(ts, js, label)
    np.testing.assert_array_equal(tmem, jmem, err_msg=label)
    assert tg.is_independent_set(tmem), label
    assert tg.set_weight(tmem) == jg.set_weight(jmem)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_greedy_equals_sequential_priority_greedy(name):
    """Distributed weighted Luby == the sequential priority greedy."""
    tg = GRAPHS[name](tgen)
    w_seq, mem_seq = tseq.solve_greedy(tg)
    for p in (1, 3):
        pg = tpart.partition_graph(tg, p, window_cap=8)
        mem, _ = TS.solve(pg, "greedy", TD.DisReduConfig(backend="blocked"),
                          device="cpu")
        np.testing.assert_array_equal(mem, np.asarray(mem_seq, bool))
        assert tg.set_weight(mem) == w_seq


def test_peel_takes_first_index_among_tied_scores():
    """RnP peels argmax per PE; with ties both sides take the first index
    (PE 0 all tied, PE 1 tied at two places, PE 2 with nothing to peel)."""
    _, jpg, _, tpg = _pair("rgg", 3)
    jprob = JD.build_union_problem(jpg, "blocked")
    tprob = TD.build_union_problem(tpg, "blocked", device="cpu")
    V = jpg.V
    score = np.full(3 * V, np.iinfo(np.int32).min, np.int32)
    score[: V - 1] = 7
    score[V + 5] = score[V + 9] = 11
    jstate = JR.init_state(jprob.w0, jprob.is_local, jprob.is_ghost)
    tstate = convert.red_state(jstate)
    want = JS._union_ctx(jprob).peel(jstate, jnp.asarray(score))
    got = TS._union_ctx(tprob).peel(tstate, torch.from_numpy(score))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    peeled = np.flatnonzero(got.status.numpy() != tstate.status.numpy())
    assert peeled.tolist() == [0, V + 5]


def test_exchange_union_matches_reference():
    """One halo exchange from a random mid-solve state in which interface
    vertices on both sides of cut edges propose to include (the Lemma
    4.4/4.5 conflict case) and ghosts went stale."""
    from repro.core import exchange as JX

    _, jpg, _, tpg = _pair("rhg", 4)
    jprob = JD.build_union_problem(jpg, "blocked")
    tprob = TD.build_union_problem(tpg, "blocked", device="cpu")
    rng = np.random.default_rng(9)
    js = JR.init_state(jprob.w0, jprob.is_local, jprob.is_ghost)
    status = np.asarray(js.status).copy()
    live = status == JR.UNDECIDED
    r = rng.random(status.shape[0])
    status[live & (r < 0.2)] = JR.EXCLUDED
    status[live & np.asarray(jprob.aux.is_iface) & (r > 0.6)] = JR.INCLUDED
    w = np.asarray(js.w) - rng.integers(0, 3, status.shape[0]) * live
    js = js._replace(status=jnp.asarray(status),
                     w=jnp.asarray(w.astype(np.int32)))
    ts = convert.red_state(js)
    for backend in ("blocked", "torch"):
        jx, jchanged = JX.exchange_union(
            js, jprob.aux, jprob.halo, p=4,
            backend="jnp" if backend == "torch" else backend,
            plan=jprob.plan)
        tx, tchanged = TX.exchange_union(ts, tprob.aux, tprob.halo,
                                         backend=backend, plan=tprob.plan)
        _assert_state_equal(tx, jx, f"exchange/{backend}")
        assert bool(tchanged) == bool(jchanged)
    assert (tx.status.numpy() != status).any()


@pytest.mark.parametrize("name", ["rgg", "gnm"])
def test_reduce_single_pe_matches_reference(name):
    """The p = 1 entry point (sequential semantics) on both sides."""
    from repro.core.local_reduce import reduce_single_pe as jreduce

    from repro_torch.core.local_reduce import reduce_single_pe as treduce

    _, jpg, _, tpg = _pair(name, 1)
    js, _ = jreduce(jpg, schedule="cheap-fused", backend="blocked")
    ts, _ = treduce(tpg, schedule="cheap-fused", backend="cuda",
                    device="cpu")
    _assert_state_equal(ts, js, f"single-pe/{name}")
