"""Port parity of the MWIS fault harness and the checkpoint manager:
``repro_torch.distributed.{fault,checkpoint}`` against
``repro.distributed.{fault,checkpoint}`` on the same numpy-made instances.

  * the checkpoint manager: round trips of a ``RedState`` and of a frame
    stack (NamedTuple fields by name), the same manifest as the
    reference's for the same tree, integrity failure on a corrupted leaf,
    a partial write that never corrupts ``latest_step``, ``keep`` GC, and
    the async writer with a tensor changed in place after ``save``;
  * the harness: delayed and dropped boards reach the fault-free fixpoint
    (the port's ``disredu_union``), a corrupted weight is flagged, a kill
    plus restart from a checkpoint is bit-identical — each run equal to
    the reference's run under the same ``FaultPlan`` (state, rounds,
    events, violations) — and ``remesh_plan`` covers every vertex as the
    reference's does.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import partition as jpart
from repro.distributed import fault as JF
from repro.distributed.checkpoint import CheckpointManager as JCheckpoint
from repro.graphs import generators as jgen
from repro_torch.core import distributed as TD
from repro_torch.core import partition as tpart
from repro_torch.core import rules as TR
from repro_torch.distributed import fault as TF
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.graphs import generators as tgen

from _torch_jax import _release_jax_programs  # noqa: F401

#: uniform shape bucket of the reference's chaos tests
SMALL_PAD = dict(L=8, G=14, E=220, B=8, S=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# checkpoint manager
# --------------------------------------------------------------------- #


def _state(seed=0, V=37):
    rng = np.random.default_rng(seed)
    st = TR.init_state(
        torch.from_numpy(rng.integers(1, 200, V).astype(np.int32)),
        torch.from_numpy(rng.random(V) < 0.7),
        torch.from_numpy(rng.random(V) < 0.2))
    return st._replace(
        log_n=torch.tensor(5, dtype=torch.int32),
        log_v=torch.from_numpy(rng.integers(0, V, V + 1).astype(np.int32)))


def _assert_state_equal(got, want):
    assert type(got) is type(want)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.is_tensor(a) and a.dtype == b.dtype, f
        assert torch.equal(a, b), f


def test_red_state_and_frame_stack_round_trip(tmp_path):
    """The staged solver's tree: a state and a list of frame states of
    other shapes, NamedTuple fields keyed by name."""
    ck = CheckpointManager(str(tmp_path), async_write=False)
    tree = {"state": _state(0, 11), "frames": [_state(1, 37), _state(2, 20)]}
    ck.save(3, tree, extra=dict(kind="test", union_v=[37, 20, 11]))
    assert ck.latest_step() == 3
    assert ck.manifest()["extra"]["union_v"] == [37, 20, 11]
    tmpl = {"state": TD.state_template(11),
            "frames": [TD.state_template(37), TD.state_template(20)]}
    got = ck.restore(tmpl, device="cpu")
    _assert_state_equal(got["state"], tree["state"])
    for g, w in zip(got["frames"], tree["frames"]):
        _assert_state_equal(g, w)
    assert "state.log_v" in ck.manifest()["leaves"]
    # without a device, tensors on the template's device; a numpy
    # template gives numpy arrays
    again = ck.restore(tmpl)
    _assert_state_equal(again["state"], tree["state"])
    host = ck.restore({"state": type(tmpl["state"])(
        *(t.numpy() for t in tmpl["state"])), "frames": tmpl["frames"]})
    assert isinstance(host["state"].w, np.ndarray)
    np.testing.assert_array_equal(host["state"].w, tree["state"].w.numpy())


def test_manifest_matches_reference(tmp_path):
    """The same tree (tensors on the port's side, arrays on the
    reference's) gives the same leaf keys, files, shapes, dtypes and
    hashes, and each package restores the other's checkpoint."""
    st = _state(4)
    ck = CheckpointManager(str(tmp_path / "port"), async_write=False)
    jck = JCheckpoint(str(tmp_path / "ref"), async_write=False)
    ck.save(1, {"state": st}, extra=dict(a=1))
    jck.save(1, {"state": type(st)(*(t.numpy() for t in st))},
             extra=dict(a=1))
    got, want = ck.manifest(), jck.manifest()
    assert got == want
    back = JCheckpoint(str(tmp_path / "port")).restore({"state": st})
    for f in st._fields:
        np.testing.assert_array_equal(getattr(back["state"], f),
                                      getattr(st, f).numpy())
    fwd = CheckpointManager(str(tmp_path / "ref")).restore(
        {"state": TD.state_template(37)}, device="cpu")
    _assert_state_equal(fwd["state"], st)


def test_integrity_check_detects_corruption(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_write=False)
    st = _state()
    path = ck.save(1, {"state": st})
    victim = os.path.join(path, "state.w.npy")
    arr = np.load(victim)
    arr[0] += 1
    np.save(victim, arr)
    with pytest.raises(IOError, match="integrity"):
        ck.restore({"state": st}, device="cpu")


def test_partial_write_never_corrupts_latest(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_write=False)
    st = _state()
    ck.save(1, {"state": st})
    # a crashed later save: a stray .tmp directory, and one whose manifest
    # never got written
    os.makedirs(os.path.join(str(tmp_path), "step_000000002.tmp"))
    os.makedirs(os.path.join(str(tmp_path), "step_000000003"))
    assert ck.latest_step() == 1 and ck.list_steps() == [1]
    _assert_state_equal(ck.restore({"state": st}, device="cpu")["state"], st)


def test_no_checkpoint_is_an_error(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.manifest()


def test_async_save_and_gc(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    st = _state()
    for s in range(5):
        st = st._replace(w=st.w + 1)
        ck.save(s, {"state": st})
    ck.wait()
    assert ck.list_steps() == [3, 4]
    got = ck.restore({"state": st}, step=4, device="cpu")
    _assert_state_equal(got["state"], st)


def test_async_writer_copies_before_it_returns(tmp_path, monkeypatch):
    """A tensor changed in place right after ``save`` returns (as the next
    stage's update would) is saved as it was at the call.  The writer
    thread is held back until the change is made, so the order is
    certain."""
    go = threading.Event()
    real_save = np.save

    def held_save(*a, **k):
        assert go.wait(timeout=60)
        return real_save(*a, **k)

    monkeypatch.setattr(np, "save", held_save)
    ck = CheckpointManager(str(tmp_path), async_write=True)
    st = _state()
    want = st.w.clone()
    ck.save(0, {"state": st})
    st.w.add_(1000)           # the caller goes on before the write ends
    go.set()
    ck.wait()
    monkeypatch.undo()
    got = ck.restore({"state": st}, device="cpu")["state"]
    assert torch.equal(got.w, want)
    meta = json.load(open(os.path.join(str(tmp_path), "step_000000000",
                                       "manifest.json")))
    assert meta["leaves"]["state.w"]["shape"] == [37]


# --------------------------------------------------------------------- #
# the fault harness against the reference's
# --------------------------------------------------------------------- #


def _problem(seed, p=2):
    """The same small random graph partitioned by both packages, and the
    union problems (the reference's ``jnp``, the port's ``torch``)."""
    jg = jgen.random_graph(12, 0.3, seed=seed)
    tg = tgen.random_graph(12, 0.3, seed=seed)
    kw = dict(window_cap=8, common_cap=4, pad_to=SMALL_PAD)
    jpg = jpart.partition_graph(jg, p, **kw)
    tpg = tpart.partition_graph(tg, p, **kw)
    jcfg = JD.DisReduConfig(heavy_k=6, mode="sync", max_rounds=200)
    tcfg = TD.DisReduConfig(heavy_k=6, mode="sync", max_rounds=200)
    return (JD.build_union_problem(jpg, jcfg.backend), jcfg,
            TD.build_union_problem(tpg, tcfg.backend, device="cpu"), tcfg,
            tpg)


def _plans(plan):
    """One FaultPlan as (reference's, port's)."""
    if plan is None:
        return None, None
    return plan, TF.FaultPlan(**dataclasses.asdict(plan))


def _run_both(seed, plan, p=2):
    jprob, jcfg, tprob, tcfg, _ = _problem(seed, p)
    jplan, tplan = _plans(plan)
    js, jr, jrep = JF.run_union_reduction(jprob, jcfg, faults=jplan)
    ts, tr, trep = TF.run_union_reduction(tprob, tcfg, faults=tplan)
    assert tr == jr
    for f in ("w", "status", "offset", "log_n"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert trep == jrep
    return ts, trep, tprob, tcfg


def _assert_same_fixpoint(state, tprob, tcfg):
    base, _ = TD.disredu_union(tprob, tcfg)
    assert torch.equal(state.w, base.w)
    assert torch.equal(state.status, base.status)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_fixpoint_under_injected_delays(seed):
    st, rep, tprob, tcfg = _run_both(seed, None)
    assert rep["fixpoint"] and not rep["violations"]
    _assert_same_fixpoint(st, tprob, tcfg)
    for fseed in range(3):
        plan = JF.FaultPlan.random_delay(fseed, p=2)
        assert TF.FaultPlan.random_delay(fseed, p=2) == _plans(plan)[1]
        st, rep, _, _ = _run_both(seed, plan)
        assert rep["fixpoint"] and not rep["violations"], plan
        _assert_same_fixpoint(st, tprob, tcfg)


@pytest.mark.parametrize("p", [2, 3])
def test_same_fixpoint_under_dropped_boards(p):
    plan = JF.FaultPlan(drop_pe=1, drop_rounds=2, drop_from=0)
    st, rep, tprob, tcfg = _run_both(5, plan, p=p)
    assert rep["fixpoint"] and not rep["violations"]
    assert any(e[0] == "dropped" for e in rep["events"])
    _assert_same_fixpoint(st, tprob, tcfg)


def test_weight_corruption_is_detected():
    plan = JF.FaultPlan(seed=1, corrupt_pe=0, corrupt_round=0)
    _, rep, _, _ = _run_both(9, plan)
    assert any(e[0] == "corrupted" for e in rep["events"])
    assert any(v[0] == "weight_increased" for v in rep["violations"])


def test_fault_free_run_matches_disredu():
    st, rep, tprob, tcfg = _run_both(11, None)
    assert rep["fixpoint"]
    _assert_same_fixpoint(st, tprob, tcfg)


@pytest.mark.parametrize("graph,kill_round", [("small", 1), ("rgg", 1),
                                              ("rgg", 3)])
def test_restart_from_checkpoint_is_bit_identical(tmp_path, graph,
                                                  kill_round):
    if graph == "small":
        jprob, jcfg, tprob, tcfg, _ = _problem(seed=7)
    else:   # DisReduA with one sweep a round: many rounds to kill in
        jg, tg = (gen.rgg2d(200, avg_deg=8, seed=7) for gen in (jgen, tgen))
        kw = dict(heavy_k=6, mode="async", stale_sweeps=1)
        jcfg, tcfg = JD.DisReduConfig(**kw), TD.DisReduConfig(**kw)
        jprob = JD.build_union_problem(jpart.partition_graph(jg, 3), "jnp")
        tprob = TD.build_union_problem(tpart.partition_graph(tg, 3), "torch",
                                       device="cpu")
    base, rounds, _ = TF.run_union_reduction(tprob, tcfg)
    assert rounds > kill_round

    ck = CheckpointManager(str(tmp_path / "port"))
    jck = JCheckpoint(str(tmp_path / "ref"))
    with pytest.raises(TF.InjectedFault):
        TF.run_union_reduction(tprob, tcfg, ckpt=ck, save_every=1,
                               faults=TF.FaultPlan(kill_round=kill_round))
    with pytest.raises(JF.InjectedFault):
        JF.run_union_reduction(jprob, jcfg, ckpt=jck, save_every=1,
                               faults=JF.FaultPlan(kill_round=kill_round))
    step = ck.latest_step()
    assert step == jck.latest_step() == kill_round - 1

    template = TR.init_state(tprob.w0, tprob.is_local, tprob.is_ghost)
    restored = ck.restore(template, device="cpu")
    st, _, rep = TF.run_union_reduction(tprob, tcfg, state=restored,
                                        start_round=step + 1)
    assert rep["fixpoint"]
    for f in ("w", "status", "offset", "log_n", "log_kind", "log_v",
              "log_u"):
        assert torch.equal(getattr(st, f), getattr(base, f)), f
    jrestored = jck.restore(template._replace(
        **{f: getattr(template, f).numpy() for f in template._fields}))
    js, _, _ = JF.run_union_reduction(jprob, jcfg, state=jrestored,
                                      start_round=step + 1)
    np.testing.assert_array_equal(st.w.numpy(), np.asarray(js.w))
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(js.status))


@pytest.mark.parametrize("n,p_old,p_new", [(1000, 4, 6), (1000, 6, 4),
                                           (17, 3, 5), (64, 1, 8)])
def test_remesh_plan_covers_everything(n, p_old, p_new):
    plan = TF.remesh_plan(n, p_old, p_new)
    assert plan == JF.remesh_plan(n, p_old, p_new)
    new = np.linspace(0, n, p_new + 1).astype(np.int64)
    for j, segs in enumerate(plan["copies"]):
        assert sum(s["size"] for s in segs) == new[j + 1] - new[j]
