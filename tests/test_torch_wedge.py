"""Port parity: the per-edge window intersection (C, K) of the port against
the JAX Pallas kernel (interpret mode), its oracle and its ops wrapper, on
random operands, on a partitioned graph and on the union problem and
reduced state of a small port run.  All int32: exact everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wedge_intersect import ops as jops
from repro.kernels.wedge_intersect.kernel import wedge_intersect
from repro.kernels.wedge_intersect.ref import (
    wedge_intersect_ref as jwedge_ref,
)
from repro_torch import kernels
from repro_torch.core import distributed as TD
from repro_torch.core import partition as tpart
from repro_torch.core import rules as TR
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.wedge_intersect import kernel as tkernel
from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
from repro_torch.kernels.wedge_intersect.ref import (
    common_neighbor_stats_ref, wedge_intersect_ref,
)
from tests.test_torch_cuda import layout_windows

from _torch_jax import _release_jax_programs  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# the shapes of tests/test_kernels.py::test_wedge_intersect_kernel_matches_ref
@pytest.mark.parametrize("E,D,e_blk", [(100, 8, 32), (513, 16, 256), (7, 4, 8)])
def test_wedge_ref_matches_pallas_kernel(E, D, e_blk):
    rng = np.random.default_rng(1)
    V = 50
    ops = [rng.integers(0, V + 1, size=(E, D)).astype(np.int32),
           rng.integers(0, V + 1, size=(E, D)).astype(np.int32),
           rng.integers(0, 200, size=(E, D)).astype(np.int32),
           rng.integers(0, 2, size=(E, D)).astype(np.int32)]
    got = wedge_intersect_ref(*map(torch.from_numpy, ops))
    _equal(got, wedge_intersect(*map(jnp.asarray, ops), e_blk=e_blk,
                                interpret=True))
    _equal(got, jwedge_ref(*map(jnp.asarray, ops)))


def _stats_both(window, weights, active, row, col):
    """(port op on CPU tensors, JAX op forced through the Pallas kernel) on
    the same numpy arrays; the port must not count a kernel launch."""
    before = kernels.launch_count("wedge_intersect")
    got = common_neighbor_stats(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (window, weights, active, row,
                                            col)))
    assert kernels.launch_count("wedge_intersect") == before
    want = jops.common_neighbor_stats(
        *(jnp.asarray(a) for a in (window, weights, active, row, col)),
        force_pallas=True)
    return got, want


@pytest.mark.parametrize("n_vertices,n_edges,d", [
    (51, 100, 8), (51, 513, 16), (51, 7, 4), (40, 300, 7), (30, 200, 32),
])
def test_common_neighbor_stats_matches_pallas_wrapper(n_vertices, n_edges, d):
    """Random windows with repeated entries, random activity: the port's op
    == the JAX op through the Pallas kernel == the port's plain version."""
    rng = np.random.default_rng(2)
    args = (rng.integers(0, n_vertices, size=(n_vertices, d)).astype(np.int32),
            rng.integers(0, 200, size=n_vertices).astype(np.int32),
            rng.integers(0, 2, size=n_vertices).astype(bool),
            rng.integers(0, n_vertices, size=n_edges).astype(np.int32),
            rng.integers(0, n_vertices, size=n_edges).astype(np.int32))
    got, want = _stats_both(*args)
    _equal(got, want)
    _equal(got, common_neighbor_stats_ref(*map(torch.from_numpy, args)))


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "duplicates",
                                  "all_nil"])
@pytest.mark.parametrize("d", [4, 5, 8, 16, 32])
def test_common_neighbor_stats_window_layouts(kind, d):
    """Every window layout the JAX function takes — sorted with nil
    padding last, unsorted, duplicate-heavy, rows of nil only — with the
    nil slot active (so nil entries count where they match): the port ==
    JAX through the Pallas kernel == the plain version."""
    rng = np.random.default_rng(d)
    n_vertices, n_edges = 40, 150
    weights = rng.integers(0, 200, size=n_vertices).astype(np.int32)
    active = rng.integers(0, 2, size=n_vertices).astype(bool)
    active[-1] = True
    args = (layout_windows(rng, kind, n_vertices, d), weights, active,
            rng.integers(0, n_vertices, size=n_edges).astype(np.int32),
            rng.integers(0, n_vertices, size=n_edges).astype(np.int32))
    got, want = _stats_both(*args)
    _equal(got, want)
    _equal(got, common_neighbor_stats_ref(*map(torch.from_numpy, args)))
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("p", [1, 4])
def test_partition_windows_are_sorted_with_nil_last(p):
    """The layout the kernel's design and ``chip_smoke.py``'s merge bound
    rely on: every window row of ``partition_graph`` (and of the union
    problem, whose per-PE offsets are monotone) holds its real entries in
    strictly ascending order, then only nil, the row's largest index."""
    g = tgen.rgg2d(400, avg_deg=9, seed=3)
    pg = tpart.partition_graph(g, p, window_cap=8)
    nil = pg.V - 1
    prob = TD.build_union_problem(pg, "torch", device="cpu")
    windows = [(w, nil) for w in pg.window] + [
        (prob.aux.window.numpy()[i * pg.V:(i + 1) * pg.V], i * pg.V + nil)
        for i in range(p)]
    padded = 0
    for window, pe_nil in windows:
        real = window != pe_nil
        # nil padding last: no real entry after a nil one
        assert not (~real[:, :-1] & real[:, 1:]).any()
        step = np.diff(window.astype(np.int64), axis=1)
        assert (step[real[:, 1:]] > 0).all()        # real entries ascending
        assert (window[real] < pe_nil).all()        # nil is the largest
        padded += int((~real[:pg.L]).any(1).sum())
    assert padded > 0


@pytest.mark.parametrize("p,window_cap", [(1, 8), (2, 8), (3, 16)])
def test_common_neighbor_stats_on_a_partitioned_graph(p, window_cap):
    """The union problem of a graph partitioned by the port's own
    ``core/partition.py``, all vertices of the initial state active: the
    port == JAX, and where both ends are local vertices whose windows hold
    their whole neighborhood (``win_complete``) C is the weight of the
    common neighborhood and K its size (the set computation of
    tests/test_kernels.py::test_wedge_ops_counts_common_neighbors; a
    ghost's window lacks its neighbors on other PEs and other ghosts)."""
    g = tgen.random_graph(30, 0.3, seed=7)
    pg = tpart.partition_graph(g, p, window_cap=window_cap)
    prob = TD.build_union_problem(pg, "torch", device="cpu")
    aux = prob.aux
    active = (prob.is_local | prob.is_ghost).numpy()
    got, want = _stats_both(aux.window.numpy(), prob.w0.numpy(), active,
                            aux.row.numpy(), aux.col.numpy())
    _equal(got, want)
    c, k = (t.numpy() for t in got)
    gid = aux.gid.numpy()
    whole = (aux.is_local & aux.win_complete).numpy()
    checked = 0
    for e, (r, cc) in enumerate(zip(aux.row.numpy(), aux.col.numpy())):
        if not (whole[r] and whole[cc]):
            continue
        u, v = int(gid[r]), int(gid[cc])
        common = set(g.neighbors(u).tolist()) & set(g.neighbors(v).tolist())
        assert c[e] == sum(int(g.weights[x]) for x in common), e
        assert k[e] == len(common), e
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("mode,schedule", [("async", "cheap-fused"),
                                           ("sync", "cheap")])
def test_common_neighbor_stats_on_a_reduced_state(mode, schedule):
    """The union problem and the reduced state of a port run on the CPU
    (folded and decided vertices inactive, folded weights in ``w``), and
    its initial state: the port == JAX through the Pallas kernel."""
    g = tgen.rgg2d(300, avg_deg=7, seed=1)
    pg = tpart.partition_graph(g, 4, window_cap=16)
    cfg = TD.DisReduConfig(mode=mode, schedule=schedule, backend="blocked")
    state, prob, rounds = TD.disredu(pg, cfg, device="cpu")
    assert rounds > 1
    aux = prob.aux
    init = TR.init_state(prob.w0, prob.is_local, prob.is_ghost)
    for st in (init, state):
        active = (st.status == TD.UNDECIDED).numpy()
        got, want = _stats_both(aux.window.numpy(), st.w.numpy(), active,
                                aux.row.numpy(), aux.col.numpy())
        _equal(got, want)
    assert not np.array_equal(init.status.numpy(), state.status.numpy())


def test_wedge_wrapper_refuses_what_it_cannot_run():
    """The kernel wrapper checks before it builds or launches anything: a
    wrong type, a window wider than 32, mixed devices and CPU tensors
    raise, and nothing is counted as a launch; the op raises on a mix."""
    window = torch.zeros((4, 8), dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.int32)
    active = ones.bool()
    before = kernels.launch_count("wedge_intersect")
    with pytest.raises(TypeError, match="int32"):
        tkernel.wedge_intersect(window.long(), ones, active, ones, ones)
    with pytest.raises(TypeError, match="bool or uint8"):
        tkernel.wedge_intersect(window, ones, ones, ones, ones)
    with pytest.raises(ValueError, match="width 33"):
        tkernel.wedge_intersect(torch.zeros((4, 33), dtype=torch.int32),
                                ones, active, ones, ones)
    with pytest.raises(ValueError, match="is on meta"):
        tkernel.wedge_intersect(window, ones, active, ones.to("meta"), ones)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.wedge_intersect(window, ones, active, ones, ones)
    with pytest.raises(ValueError, match="expected all on the CPU"):
        common_neighbor_stats(window, ones, active.to("meta"), ones, ones)
    assert kernels.launch_count("wedge_intersect") == before
