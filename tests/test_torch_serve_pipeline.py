"""The port's serve pipeline and serve mesh against the reference's.

Counterparts of the reference's multi-device serving tests
(``tests/test_serve.py``: batch sizes on a device multiple, excess
devices, pipeline parity and stage statistics, the single-chunk path,
poisoned batchmates, dispatch failures, descent, and its sharded script on
four host devices).  Here four CPU "devices" come from replacing
``launch.mesh.visible_devices``; every request's members and weight must
equal the JAX service's (its default, pipelined, on one device) and the
port's own ``devices=1, pipeline=False`` service."""

import contextlib
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro.core import serve as JSV
from repro.core.graph import Graph as JGraph
from repro_torch import kernels
from repro_torch.core import serve as TSV
from repro_torch.core import validate as TV
from repro_torch.core.graph import Graph as TGraph
from repro_torch.graphs import generators as tgen
from repro_torch.launch import mesh
from repro_torch.launch import serve as tlaunch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def four_cpus(monkeypatch):
    """Four CPU devices visible to the serve mesh, as the reference's
    sharded tests force four host devices."""
    monkeypatch.setattr(mesh, "visible_devices",
                        lambda kind: (torch.device(kind),) * 4)


#: A ragged batch over two cells: 8 serve_xs requests (not a multiple of
#: the device count in every chunk) and 2 serve_s ones.
REQS = ([tgen.gnm(20 + 3 * i, 40 + 5 * i, seed=i) for i in range(8)]
        + [tgen.gnm(120, 300, seed=8), tgen.gnm(130, 320, seed=9)])

NAN = TGraph(indptr=np.array([0, 1, 2]), indices=np.array([1, 0], np.int32),
             weights=np.array([np.nan, 1.0]))


def _jgraph(g):
    return JGraph(indptr=g.indptr, indices=g.indices, weights=g.weights)


_JAX: dict = {}


def _reference(algo):
    """The JAX service's results on ``REQS`` (its defaults: pipelined, on
    one device, ``jnp``), computed once per algo in this module."""
    if algo not in _JAX:
        svc = JSV.MWISService(JSV.ServeConfig(algo=algo, backend="jnp",
                                              max_batch=8))
        _JAX[algo] = svc.solve_batch([_jgraph(g) for g in REQS])
        assert all(r.ok for r in _JAX[algo])
    return _JAX[algo]


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
# the serve mesh and batch sizes
# --------------------------------------------------------------------- #


def test_serve_mesh_takes_the_first_visible_devices(monkeypatch):
    assert mesh.make_serve_mesh(None, "cpu") == (torch.device("cpu"),)
    devs = tuple(torch.device("cuda", i) for i in range(3))
    monkeypatch.setattr(mesh, "visible_devices", lambda kind: devs)
    assert mesh.make_serve_mesh() == devs
    assert mesh.make_serve_mesh(2) == devs[:2]
    for n in (0, 4):
        with pytest.raises(ValueError, match="only 3 visible"):
            mesh.make_serve_mesh(n)


def test_batch_size_rounds_to_device_multiple(four_cpus):
    svc = _tsvc()
    assert svc._ndev == 4 and svc.stats["devices"] == 4
    assert svc._batch_size(1) == 4      # bucket 1 rounds up to a shardable 4
    assert svc._batch_size(3) == 4
    assert svc._batch_size(5) == 16     # bucket 16 already a multiple
    cell = svc.cells[0]._replace(serve_devices=2)
    assert svc._cell_ndev(cell) == 2    # per-cell cap wins over the mesh
    assert svc._batch_size(1, cell) == 2
    one = _tsvc(devices=1)
    assert one._batch_size(1) == 1      # single device: buckets unchanged
    assert one._batch_size(5) == 16


def test_batch_size_respects_max_batch_fallthrough(four_cpus):
    svc = _tsvc(max_batch=8)
    # no static bucket fits in (7, 8] -> fall through, still device-aligned
    assert svc._batch_size(7) == 8
    assert _tsvc(max_batch=6)._batch_size(6) == 8


def test_service_rejects_excess_devices(four_cpus):
    with pytest.raises(ValueError, match="exceeds the 4 visible"):
        _tsvc(devices=5)
    with pytest.raises(ValueError, match="device type"):
        TSV.MWISService(TSV.ServeConfig(device="cpu:0"))


def test_serve_cli_rejects_excess_devices(capsys):
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", "mwis", "--device", "cpu",
                      "--devices", "4096"])
    assert e.value.code == 2
    assert "visible" in capsys.readouterr().err


# --------------------------------------------------------------------- #
# the pipeline on one device
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", ["torch", "blocked"])
@pytest.mark.parametrize("algo", ["greedy", "rg", "rnp"])
def test_pipeline_matches_sync_and_reference(algo, backend):
    """Three chunks (two of serve_xs, one of serve_s) pipelined: every
    request equal to the synchronous service's and the JAX service's, and
    the stage statistics cover every chunk either way."""
    on = _tsvc(algo=algo, backend=backend, max_batch=4)
    off = _tsvc(algo=algo, backend=backend, max_batch=4, pipeline=False)
    r_on = on.solve_batch(REQS)
    _same(r_on, off.solve_batch(REQS), f"{algo}/{backend}: on vs off")
    _same(r_on, _reference(algo), f"{algo}/{backend}: vs reference")
    s_on, s_off = on.stats, off.stats
    assert s_on["pipeline"] is True and s_off["pipeline"] is False
    assert s_on["pipelined_chunks"] == s_on["chunks"] == 3
    assert s_off["pipelined_chunks"] == 0 and s_off["chunks"] == 3
    assert s_on["pipeline_retries"] == 0 and s_on["devices"] == 1
    for s in (s_on, s_off):
        assert s["stage_ms"]["pack"] > 0 and s["stage_ms"]["solve"] > 0
        assert set(s["stage_p50_ms"]) == {"pack", "transfer", "solve",
                                          "fetch"}
        assert s["wall_ms"] > 0 and 0.0 <= s["overlap_ratio"] < 1.0
    assert s_off["overlap_ratio"] == 0.0


def test_pipeline_single_chunk_takes_sync_path():
    # one chunk has nothing to overlap with -> the sync path runs (this
    # also keeps the _execute_chunk monkeypatch seam on solve_one)
    svc = _tsvc()
    assert svc.solve_one(REQS[0]).ok
    assert svc.stats["pipelined_chunks"] == 0 and svc.stats["chunks"] == 1


def test_cell_pipeline_opt_out_runs_synchronously():
    cells = tuple(c._replace(pipeline=c.name != "serve_s")
                  for c in TSV.serve_cells())
    svc = TSV.MWISService(TSV.ServeConfig(device="cpu", max_batch=4), cells)
    _same(svc.solve_batch(REQS), _reference("rg"), "serve_s opted out")
    st = svc.stats
    assert st["chunks"] == 3 and st["pipelined_chunks"] == 2


def test_pipeline_poisoned_batchmates_are_isolated():
    svc = _tsvc(max_batch=2)
    res = svc.solve_batch([REQS[0], REQS[1], NAN, REQS[2], REQS[3],
                           REQS[4]])
    assert not res[2].ok and res[2].reason == TV.REASON_BAD_WEIGHT
    _same(res[:2] + res[3:], _reference("rg")[:5], "poisoned, pipelined")
    assert svc.stats["pipelined_chunks"] == svc.stats["chunks"] == 3


def test_pipeline_dispatch_failure_falls_back_to_sync_path(monkeypatch):
    # a launch that raises mid-pipeline must not lose the chunk: it is
    # retired through the synchronous fallback-chain path
    svc = _tsvc(max_batch=2)
    boom = {"n": 0}
    real = TSV.MWISService._launch_chunk

    def flaky(self, staged):
        boom["n"] += 1
        if boom["n"] == 1:
            raise RuntimeError("injected launch failure")
        return real(self, staged)

    monkeypatch.setattr(TSV.MWISService, "_launch_chunk", flaky)
    _same(svc.solve_batch(REQS[:4]), _reference("rg")[:4], "dispatch retry")
    st = svc.stats
    assert st["pipeline_retries"] == 1 and st["fallbacks"] == 0
    assert st["chunks"] == 2 and st["pipelined_chunks"] == 1


def test_pipeline_worker_failure_reaches_retire(monkeypatch):
    """An exception raised in a worker thread (in flight) is not swallowed
    by the executor: the chunk is retired through the synchronous path."""
    svc = _tsvc(max_batch=2)
    real = TSV.MWISService._solve_shard
    seen = []

    def flaky(self, staged, s):
        seen.append(threading.current_thread() is threading.main_thread())
        if len(seen) == 2:
            raise RuntimeError("injected in-flight failure")
        return real(self, staged, s)

    monkeypatch.setattr(TSV.MWISService, "_solve_shard", flaky)
    _same(svc.solve_batch(REQS[:6]), _reference("rg")[:6], "in-flight retry")
    st = svc.stats
    assert not any(seen)                # every shard solved off the caller
    assert st["pipeline_retries"] == 1 and st["solve_errors"] == 0
    assert [e[0] for e in svc.events] == ["pipeline_retry"]
    assert "in-flight" in svc.events[0][-1]


def test_kernel_failure_in_a_worker_is_backend_failed(monkeypatch):
    """On ``cuda`` a ``segment_fused`` failure inside a worker ends as
    ``backend_failed`` after the synchronous retry; nothing runs the plain
    version instead."""
    from repro_torch.core import engine

    def broken(*a, **kw):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(engine, "segment_fused_coo", broken)
    svc = _tsvc(backend="cuda", max_batch=2)
    res = svc.solve_batch(REQS[:4])
    assert all(not r.ok and r.reason == TV.REASON_BACKEND_FAILED
               for r in res)
    assert "injected kernel failure" in res[0].error
    st = svc.stats
    assert st["fallbacks"] == 0 and st["backend_active"] == "cuda"
    assert st["pipeline_retries"] == 2 and st["solve_errors"] == 2


def test_launch_counts_survive_threads(monkeypatch):
    """Kernel launches counted from many threads at once lose no count."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    kernels.reset_launch_counts()
    per, n_threads = 2000, 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            kernels.launch("segment_fused", lambda *a: 0, None)
            for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launch_count("segment_fused") == per * n_threads
    kernels.reset_launch_counts()


# --------------------------------------------------------------------- #
# the sharded batch axis on four CPU devices
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", ["torch", "blocked"])
@pytest.mark.parametrize("algo", ["greedy", "rg", "rnp"])
def test_sharded_service_matches_reference(four_cpus, algo, backend):
    """A ragged two-cell batch split over four shards (pipelined), and a
    batch of one padded to a shard a device: bit for bit with ``devices=1``
    and with the JAX service."""
    want = _reference(algo)
    svc = _tsvc(algo=algo, backend=backend, max_batch=8)
    got = svc.solve_batch(REQS)
    _same(got, want, f"{algo}/{backend}: sharded vs reference")
    one = _tsvc(algo=algo, backend=backend, max_batch=8, devices=1,
                pipeline=False)
    _same(got, one.solve_batch(REQS), f"{algo}/{backend}: vs devices=1")
    st = svc.stats
    assert st["devices"] == 4 and st["solve_errors"] == 0
    assert st["chunks"] == st["pipelined_chunks"] == 2
    assert [(r["batch"], r["devices"]) for r in svc._stage_log] == [
        (8, 4), (4, 4)]
    single = _tsvc(algo=algo, backend=backend)
    _same([single.solve_one(REQS[9])], want[9:], "batch of one")
    assert [(r["batch"], r["devices"]) for r in single._stage_log] == [
        (4, 4)]


def test_sharded_poisoned_batchmates_are_isolated(four_cpus):
    svc = _tsvc(max_batch=8)
    res = svc.solve_batch([REQS[0], NAN, REQS[1], REQS[2]])
    assert not res[1].ok and res[1].reason == TV.REASON_BAD_WEIGHT
    _same([res[0]] + res[2:], _reference("rg")[:3], "poisoned, sharded")


def test_sharded_cell_cap(four_cpus):
    cells = tuple(c._replace(serve_devices=2) for c in TSV.serve_cells())
    svc = TSV.MWISService(TSV.ServeConfig(device="cpu", max_batch=8), cells)
    _same(svc.solve_batch(REQS), _reference("rg"), "two of four devices")
    assert [(r["batch"], r["devices"]) for r in svc._stage_log] == [
        (8, 2), (4, 2)]


def test_sharded_descent_auto_takes_the_first_device(four_cpus):
    """descent="auto" instances bypass the sharded and pipelined chunks:
    each is solved alone by the staged path on the service's first device,
    equal to the single-device services (the port's and the JAX one)."""
    reqs = [REQS[0], tgen.gnm(200, 700, seed=0), REQS[1]]
    kw = dict(descent="auto", descent_min_L=256, verify="full")
    svc = _tsvc(**kw)
    got = svc.solve_batch(reqs)
    _same(got, _tsvc(devices=1, pipeline=False, **kw).solve_batch(reqs),
          "descent: vs devices=1")
    want = JSV.MWISService(JSV.ServeConfig(backend="jnp", **kw)).solve_batch(
        [_jgraph(g) for g in reqs])
    _same(got, want, "descent: vs reference")
    st = svc.stats
    assert st["descent_solves"] == 1 and st["chunks"] == 1
    assert svc.device == torch.device("cpu")
