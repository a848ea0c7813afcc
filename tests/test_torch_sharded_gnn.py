"""The dry-run's GNN half as sharded programs: the 16 GNN cells counted
on the production meshes, one rank of a fake process group on meta
DTensors, against the reference's GSPMD layouts; and the rules of the
message passing's ops (``models/gnn/common.py``) run for real.

  (a) each GNN arch's ``param_specs(cfg, fsdp)`` equals the reference's,
      leaf by leaf, for fsdp ("data",) and ("pod", "data");
  (b) every GNN cell's inputs on both production meshes: the (global
      shape, shard shape) of each leaf equals the reference's
      ``in_shardings`` (node arrays over the fsdp axes; ``row``, ``col``
      and ``triplets`` over fsdp + ``model``; ``energy`` replicated);
  (c) a SMOKE training step of each arch on the (data 2, model 4) mesh
      against the reference's compiled with its shardings (its scans
      unrolled; equiformer in 4 edge chunks): argument bytes equal (the
      inputs each program reads), matmul FLOPs within [0.9, 1.1] and
      collective bytes within [0.6, 1.9] of XLA's, XLA's all-reduces taken
      at their bytes over the group size (the reduce-scatter the port
      runs where XLA all-reduces the node sums: hlo.py's convention as
      ``test_torch_sharded.py`` applies it to the LMs); ``pytest -s``
      prints each ratio and each kind;
  (d) no work dropped: 8 × a rank's matmul FLOPs and argument bytes at
      least the unsharded step's;
  (e) on a real 4-rank gloo group of CPU processes, a (data 2, model 2)
      mesh, each SMOKE step's loss and its gradients gathered whole equal
      the unsharded step's on the same seed (rtol 1e-5 on the loss;
      rtol 1e-4, atol 1e-6 on the gradients: float32 partial sums taken
      in another order).

The reference's and the port's sides run in subprocesses of
``tests/_sharded_ref.py``: JAX needs its host devices set before it
loads, a fake process group is one world a process, and the gloo ranks
are spawned processes.
"""

import concurrent.futures
import importlib
import json

import numpy as np
import pytest
import torch

from _torch_jax import _release_jax_programs  # noqa: F401
from test_torch_sharded import _run, _spec_leaves

GNN_ARCHS = {"graphsage-reddit": "graphsage_reddit",
             "gatedgcn": "gatedgcn_cfg", "dimenet": "dimenet_cfg",
             "equiformer-v2": "equiformer_v2_cfg"}
#: The SMOKE steps of (c), (d) and (e): arch -> (shape, overrides);
#: equiformer's 4096-edge chunks cut molecule's 16,384 edges into 4.
SMOKE_CELLS = {"graphsage-reddit": ("full_graph_sm", {}),
               "gatedgcn": ("full_graph_sm", {}),
               "dimenet": ("molecule", {}),
               "equiformer-v2": ("molecule", {"edge_chunk": 4096})}
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# (a) every leaf's spec
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fsdp", [("data",), ("pod", "data")])
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_param_specs_equal_reference(arch_id, fsdp):
    mod = GNN_ARCHS[arch_id]
    jmod = importlib.import_module("repro.configs." + mod)
    tmod = importlib.import_module("repro_torch.configs." + mod)
    ref = dict(_spec_leaves(jmod.module.param_specs(jmod.CONFIG, fsdp)))
    port = dict(_spec_leaves(tmod.module.param_specs(tmod.CONFIG, fsdp)))
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert tuple(port[k].pspec) == tuple(ref[k].pspec), k


# --------------------------------------------------------------------- #
# (b) local shard shapes of every GNN cell's inputs
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gnn_shards():
    ref, single, multi = _run(("gnn-shards", "512"),
                              ("port-gnn-shards", "single"),
                              ("port-gnn-shards", "multi"))
    return ref, single | multi


@pytest.mark.parametrize("mesh_kind", ("single", "multi"))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_local_shards_equal_reference(gnn_shards, arch_id, shape,
                                          mesh_kind):
    ref, port = gnn_shards
    assert sorted(ref) == sorted(port) and len(ref) == 32
    cell = f"{arch_id}/{shape}/{mesh_kind}"
    assert port[cell] == ref[cell]


# --------------------------------------------------------------------- #
# (c), (d) SMOKE steps against the reference compiled on 8 devices
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gnn_steps():
    """{arch: (the reference's side, the port's side)}, four subprocesses
    at a time."""
    commands = [(side, arch, shape, json.dumps(ov))
                for arch, (shape, ov) in SMOKE_CELLS.items()
                for side in ("gnn-small", "port-gnn-small")]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        out = list(pool.map(lambda c: _run(c)[0], commands))
    return {arch: (out[2 * i], out[2 * i + 1])
            for i, arch in enumerate(SMOKE_CELLS)}


@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_smoke_step_per_device_against_reference(gnn_steps, arch_id):
    ref, port = gnn_steps[arch_id]
    ref_coll, port_coll = ref["collectives"], port["collectives"]
    kinds = sorted(set(ref_coll) | set(port_coll))
    xla = (sum(ref_coll.values()) - ref_coll.get("all-reduce", 0)
           + ref["all_reduce_shard_bytes"])
    matmul = port["matmul"] / ref["matmul"]
    coll = sum(port_coll.values()) / xla
    print(f"\n{arch_id} at {SMOKE_CELLS[arch_id][0]} on 2x4, port / "
          f"reference: matmul {matmul:.4f}, collective bytes {coll:.4f} "
          f"(raw {sum(port_coll.values()) / sum(ref_coll.values()):.4f}); "
          f"by kind (port, reference): " + ", ".join(
              f"{k} {port_coll.get(k, 0)} {ref_coll.get(k, 0)}"
              for k in kinds)
          + f"; XLA's all-reduces over their groups "
            f"{ref['all_reduce_shard_bytes']:.0f}")
    assert port["argument_bytes"] == ref["argument_bytes"]
    # 0.986-1.013 of XLA's
    assert 0.9 <= matmul <= 1.1
    # the port reduce-scatters node sums where XLA all-reduces them
    # whole, and gathers node tables where XLA moves some edge arrays:
    # 0.75-1.73 (PERF.md §6 gives every ratio)
    assert 0.6 <= coll <= 1.9


@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_no_work_dropped(gnn_steps, arch_id):
    _, port = gnn_steps[arch_id]
    assert 8 * port["matmul"] >= port["whole_matmul"]
    assert 8 * port["argument_bytes"] >= port["whole_argument_bytes"]


# --------------------------------------------------------------------- #
# (e) the rules on a real 4-rank gloo group
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gloo_steps():
    cells = [[arch, shape, ov] for arch, (shape, ov) in SMOKE_CELLS.items()]
    (out,) = _run(("gloo-gnn", json.dumps(cells)))
    return out


@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_sharded_step_equals_unsharded(gloo_steps, arch_id):
    res = gloo_steps[arch_id]
    np.testing.assert_allclose(res["loss"], res["loss0"], rtol=1e-5)
    assert len(res["grads"]) == len(res["grads0"])
    for got, want in zip(res["grads"], res["grads0"]):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
