"""Port parity: the aggregate engine (compute_ctx, sweep, heavy vertex) on
random mid-solve states, started on both sides from one state carried
across with ``repro_torch.convert``.  Exact equality (int32 payloads).

Backend pairs: port ``torch`` / ``blocked`` / ``cuda`` (its plain version
on CPU tensors) against JAX ``jnp`` / ``blocked`` / ``pallas`` (interpret).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import engine as JE
from repro.core import partition as jpart
from repro.core import rules as JR
from repro.graphs import generators as jgen
from repro_torch import convert
from repro_torch.core import distributed as TD
from repro_torch.core import engine as TE
from repro_torch.core import partition as tpart
from repro_torch.core import rules as TR
from repro_torch.graphs import generators as tgen

from _torch_jax import _release_jax_programs  # noqa: F401

PAIRS = [("jnp", "torch"), ("blocked", "blocked"), ("pallas", "cuda")]

GRAPHS = {
    "rgg": lambda gen: gen.rgg2d(240, avg_deg=7, seed=1),
    "rhg": lambda gen: gen.rhg_like(240, avg_deg=6, seed=2),
    "gnm": lambda gen: gen.gnm(200, 600, seed=3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(name, p=2):
    jpg = jpart.partition_graph(GRAPHS[name](jgen), p, window_cap=8,
                                common_cap=4)
    jprob = JD.build_union_problem(jpg, "blocked")
    return jpg, jprob, convert.union_problem(jprob)


def _mid_solve_state(jprob, seed):
    """A random reachable-looking state: some vertices decided, weights
    decreased, a few fold-log records — the nil slots stay EXCLUDED."""
    rng = np.random.default_rng(seed)
    s0 = JR.init_state(jprob.w0, jprob.is_local, jprob.is_ghost)
    status = np.asarray(s0.status).copy()
    live = status == JR.UNDECIDED
    r = rng.random(status.shape[0])
    status[live & (r < 0.15)] = JR.EXCLUDED
    status[live & (r > 0.92)] = JR.INCLUDED
    status[live & (r > 0.88) & (r <= 0.92)] = JR.FOLDED
    w = np.asarray(s0.w).copy()
    w = np.maximum(w - rng.integers(0, 60, size=w.shape[0]), 0).astype(
        np.int32)
    w[~live] = np.asarray(s0.w)[~live]
    n_log = 5
    log_v = np.asarray(s0.log_v).copy()
    log_v[:n_log] = rng.integers(0, w.shape[0], n_log)
    return s0._replace(
        w=jnp.asarray(w), status=jnp.asarray(status.astype(np.int8)),
        log_v=jnp.asarray(log_v), log_n=jnp.asarray(n_log, jnp.int32),
        offset=jnp.asarray(1234, jnp.int32),
    )


def _assert_same(got, want, label):
    g, w = convert.to_numpy(got), convert.to_numpy(want)
    assert g.keys() == w.keys()
    for k in w:
        assert (g[k] is None) == (w[k] is None), f"{label}: {k} presence"
        if w[k] is not None:
            np.testing.assert_array_equal(g[k], w[k],
                                          err_msg=f"{label}: {k}")


SCHEDULE_REQUIRES = {TE.schedule_requires(s) for s in TE.SCHEDULES.values()}
REQUIRES = sorted(
    SCHEDULE_REQUIRES | {r.requires for r in TE.RULES.values()}, key=sorted,
)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_compute_ctx_matches_reference(name):
    """Every schedule's and every rule's declared aggregates on random
    states, on all three backend pairs (Pallas interpret on one state)."""
    _, jprob, tprob = _problems(name)
    for seed in (0, 1) if name == "rgg" else (0,):
        js = _mid_solve_state(jprob, seed)
        ts = convert.red_state(js)
        for req in REQUIRES:
            # Pallas interpret on one state, for the schedules' union sets
            pallas = (name, seed) == ("rgg", 0) and req in SCHEDULE_REQUIRES
            for jb, tb in PAIRS if pallas else PAIRS[:2]:
                want = JE.compute_ctx(js, jprob.aux, req, backend=jb,
                                      plan=jprob.plan)
                got = TE.compute_ctx(ts, tprob.aux, req, backend=tb,
                                     plan=tprob.plan)
                _assert_same(got, want, f"{name}/{seed}/{sorted(req)}/{tb}")


@pytest.mark.parametrize("schedule", sorted(TE.SCHEDULES))
def test_sweep_matches_reference(schedule):
    """One sweep of each schedule from a random state: the whole RedState
    (weights, statuses, fold log, offset, changed) is equal."""
    _, jprob, tprob = _problems("rgg")
    for seed, (jb, tb) in zip((2, 3), PAIRS[:2]):
        js = _mid_solve_state(jprob, seed)
        ts = convert.red_state(js)
        want = JE.sweep(js, jprob.aux, schedule=schedule, backend=jb,
                        plan=jprob.plan)
        got = TE.sweep(ts, tprob.aux, schedule=schedule, backend=tb,
                       plan=tprob.plan)
        assert bool(got.changed), f"{schedule}/{seed}: no rule fired"
        _assert_same(got, want, f"{schedule}/{seed}/{tb}")


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("rule", ["degree_one", "weight_transfer",
                                  "extended_single_edge"])
def test_scattering_rule_matches_reference(name, rule):
    """Each rule that scatters (the folds' weight adds, the EXCLUDED fills,
    the fold-log appends) alone from random states where a few lanes fire
    and most do not: the whole RedState is equal bit for bit, the nil
    slot of ``w`` / ``status`` and the log's ``cap - 1`` slot included."""
    _, jprob, tprob = _problems(name)
    fired = logged = 0
    for seed in (6, 8):
        js = _mid_solve_state(jprob, seed)
        ts = convert.red_state(js)
        req = TE.RULES[rule].requires
        want = JE.RULES[rule](js, jprob.aux, JE.compute_ctx(
            js, jprob.aux, req, backend="jnp"))
        got = TE.RULES[rule](ts, tprob.aux, TE.compute_ctx(
            ts, tprob.aux, req, backend="torch"))
        _assert_same(got, want, f"{name}/{seed}/{rule}")
        changed = int((got.status != ts.status).sum())
        assert changed < int((ts.status == TR.UNDECIDED).sum()) // 2
        fired += changed
        logged += int(got.log_n) - int(ts.log_n)
    assert fired > 0, f"{name}/{rule}: no lane fired"
    if rule != "extended_single_edge":
        assert logged > 0, f"{name}/{rule}: nothing was logged"


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_heavy_vertex_matches_reference(name):
    """The exact sub-MWIS rule (2^K subset enumeration, int32 sums written
    without a matmul in the port) from random states."""
    _, jprob, tprob = _problems(name)
    for seed in (4, 5):
        js = _mid_solve_state(jprob, seed)
        ts = convert.red_state(js)
        for k in (6, 8):
            want = JR.rule_heavy_vertex(js, jprob.aux, k)
            got = TR.rule_heavy_vertex(ts, tprob.aux, k)
            _assert_same(got, want, f"{name}/{seed}/K={k}")


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("p", [1, 4])
def test_build_union_problem_matches_converted(name, p):
    """The port's own partition + union build (copied numpy modules,
    torch tensors) == the JAX build carried across, field by field."""
    jpg = jpart.partition_graph(GRAPHS[name](jgen), p, window_cap=8)
    tpg = tpart.partition_graph(GRAPHS[name](tgen), p, window_cap=8)
    jprob = JD.build_union_problem(jpg, "blocked")
    conv = convert.union_problem(jprob)
    own = TD.build_union_problem(tpg, "cuda", device="cpu")
    for field in ("w0", "is_local", "is_ghost"):
        np.testing.assert_array_equal(getattr(own, field).numpy(),
                                      getattr(conv, field).numpy())
    assert (own.p, own.V) == (conv.p, conv.V)
    _assert_same(own.aux, conv.aux, "aux")
    _assert_same(own.halo, conv.halo, "halo")
    _assert_same(own.plan, conv.plan, "plan")
