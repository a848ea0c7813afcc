"""The dry-run's sharded half: LM and DLRM cells counted as sharded
programs on the production meshes, one rank of a fake process group on
meta DTensors, against the reference's GSPMD layouts.

  (a) ``models.common.sanitize_pspec`` equals the reference's over a grid
      of shapes × specs × both production meshes;
  (b) every leaf's partition spec of every LM and DLRM arch at full width
      (and the decode cache's) equals the reference's;
  (c) each input leaf's local shard shape on rank 0, over the weights,
      AdamW state, batch and decode cache of every LM and DLRM cell on
      both meshes, equals ``NamedSharding(mesh, pspec).shard_shape``;
  (d) SMOKE training steps on 8-device meshes, (data 2, model 4) and (pod
      2, data 2, model 2), against the reference's compiled with its
      shardings: argument bytes equal; DLRM's matmul FLOPs within 2 % and
      collective bytes within [0.5, 2] of XLA's; the LMs' (both sides in
      float32) matmuls split evenly over the ranks and within [0.8, 1] of
      XLA's, their collective bytes within [0.5, 2] of XLA's with XLA's
      all-reduces at the reduce-scatter convention, all-gather bytes
      within [0.5, 2] and all-to-all bytes within [0.35, 2] (``pytest
      -s`` prints each ratio and each kind);
  (e) no work dropped: a SMOKE cell's per-device matmul FLOPs × ranks at
      least its unsharded count;
  (f) a functional all-gather counts its output bytes, a shard → shard
      redistribution counts as one all-to-all, and torch's functions are
      back in place after the count.

The reference's and the port's sides of (c) and (d) run in subprocesses
of their own (``tests/_sharded_ref.py``): JAX needs its host devices set
before it loads, and a fake process group is one world a process.
"""

import concurrent.futures
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.models import common as JC
from repro_torch.analysis import count
from repro_torch.models import common as MC

from _torch_jax import _release_jax_programs  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "_sharded_ref.py"
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
SMALL = {"2x4": ((2, 4), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LM_ARCHS = {"qwen3-32b": "qwen3_32b", "qwen3-moe-235b-a22b": "qwen3_moe_235b",
            "grok-1-314b": "grok1_314b", "mistral-nemo-12b": "mistral_nemo_12b",
            "gemma3-1b": "gemma3_1b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _RefMesh:
    """What the reference's ``sanitize_pspec`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)


class _PortMesh:
    """What the port's ``sanitize_pspec`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, axes):
        self.mesh_dim_names = axes
        self.shape = shape


def _run(*commands, timeout=900) -> list:
    """Each command's JSON result from ``tests/_sharded_ref.py``, the
    commands run at once (one process each)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HELPER), *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in commands]
    out = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, stderr[-3000:]
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


# --------------------------------------------------------------------- #
# (a) sanitize_pspec
# --------------------------------------------------------------------- #
SHAPES = [(1,), (8,), (16,), (512,), (48, 6144), (128, 32768), (256, 4096),
          (8, 6144, 32768), (1, 2, 524288, 8, 256), (39884800, 128),
          (3, 128), (4096,), (0, 7)]
SPECS = [(), (None,), ("model",), ("data",), (("data",),),
         (("pod", "data"),), (("model", "data"),),
         (("model", "pod", "data"),), ("model", ("pod", "data")),
         (None, ("pod", "data"), "model"), ("data", "model", None),
         (("pod", "data", "model"),), ("pe",), (("pe", "model"),),
         (None, None, "model", None, None)]


@pytest.mark.parametrize("mesh_kind", MESHES)
def test_sanitize_pspec_equals_reference(mesh_kind):
    shape_, axes = MESHES[mesh_kind]
    ref, port = _RefMesh(shape_, axes), _PortMesh(shape_, axes)
    n = 0
    for shape in SHAPES:
        for spec in SPECS:
            if len(spec) > len(shape):
                continue
            want = tuple(JC.sanitize_pspec(shape, P(*spec), ref))
            got = MC.sanitize_pspec(shape, spec, port)
            assert tuple(got) + (None,) * (len(want) - len(got)) == want, (
                shape, spec)
            n += 1
    assert n > 100


# --------------------------------------------------------------------- #
# (b) every leaf's spec
# --------------------------------------------------------------------- #
def _spec_leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _spec_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("fsdp", [("data",), ("pod", "data")])
@pytest.mark.parametrize("arch_id", [*LM_ARCHS, "dlrm-mlperf"])
def test_param_specs_equal_reference(arch_id, fsdp):
    if arch_id == "dlrm-mlperf":
        from repro.models import dlrm as JM
        from repro_torch.models import dlrm as TM
        mod = "dlrm_mlperf"
    else:
        from repro.models import transformer as JM
        from repro_torch.models import transformer as TM
        mod = LM_ARCHS[arch_id]
    jcfg = importlib.import_module("repro.configs." + mod).CONFIG
    tcfg = importlib.import_module("repro_torch.configs." + mod).CONFIG
    ref = dict(_spec_leaves(JM.param_specs(jcfg, fsdp)))
    port = dict(_spec_leaves(TM.param_specs(tcfg, fsdp)))
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert tuple(port[k].pspec) == tuple(ref[k].pspec), k
    if arch_id != "dlrm-mlperf":
        for shard_seq in (False, True):
            _, (ref_ps, _) = JM.make_kv_cache_specs(
                jcfg, 8, 64, fsdp=fsdp, shard_seq=shard_seq)
            _, (port_ps, _) = TM.make_kv_cache_specs(
                tcfg, 8, 64, fsdp=fsdp, shard_seq=shard_seq)
            assert port_ps == tuple(ref_ps)


# --------------------------------------------------------------------- #
# (c) local shard shapes of every cell's inputs
# --------------------------------------------------------------------- #
def test_local_shards_equal_reference_shard_shapes():
    ref, single, multi = _run(("shards", "512"), ("port-shards", "single"),
                              ("port-shards", "multi"))
    port = single | multi
    assert sorted(ref) == sorted(port) and len(ref) == 40
    for cell, leaves in ref.items():
        assert port[cell] == leaves, cell


# --------------------------------------------------------------------- #
# (d) SMOKE steps against the reference compiled on 8 devices
# --------------------------------------------------------------------- #
STEPS = ("dense", "moe", "dlrm")


@pytest.fixture(scope="module")
def small_steps():
    """{(step, mesh): (the reference's side, the port's side)} of every
    case of (d), four subprocesses at a time."""
    cases = [(step, name) for step in STEPS for name in SMALL]
    commands = [(side, json.dumps(SMALL[name][0]), json.dumps(SMALL[name][1]),
                 step) for step, name in cases
                for side in ("small", "port-small")]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        out = list(pool.map(lambda c: _run(c)[0], commands))
    return {case: (out[2 * i], out[2 * i + 1])
            for i, case in enumerate(cases)}


@pytest.mark.slow
@pytest.mark.parametrize("mesh_name", SMALL)
@pytest.mark.parametrize("step", STEPS)
def test_smoke_step_per_device_against_reference(small_steps, step,
                                                 mesh_name):
    ref, port = small_steps[step, mesh_name]
    ref_coll, port_coll = ref["collectives"], port["collectives"]
    kinds = sorted(set(ref_coll) | set(port_coll))
    matmul = port["matmul"] / ref["matmul"]
    ratio = {k: port_coll.get(k, 0) / max(ref_coll.get(k, 0), 1)
             for k in kinds}
    xla = sum(ref_coll.values())
    if step != "dlrm":
        # XLA reduces the gradients of the FSDP-sharded weights by a whole
        # all-reduce and a slice, the port by a reduce-scatter (hlo.py's
        # convention: the output, one shard): XLA's all-reduces at their
        # bytes over the group size, a reduce-scatter's output.  DLRM's
        # all-reduced gradients are of replicated weights on both sides.
        xla += ref["all_reduce_shard_bytes"] - ref_coll.get("all-reduce", 0)
    coll = sum(port_coll.values()) / xla
    print(f"\n{step} on {mesh_name}, port / reference: matmul "
          f"{matmul:.4f} (port / its unsharded count over 8 ranks "
          f"{8 * port['matmul'] / port['whole_matmul']:.4f}), collective "
          f"bytes {coll:.4f}; by kind (port, reference, ratio): " + ", ".join(
              f"{k} {port_coll.get(k, 0)} {ref_coll.get(k, 0)} "
              f"{ratio[k]:.4f}" for k in kinds)
          + f"; XLA's all-reduces over their groups "
            f"{ref['all_reduce_shard_bytes']:.0f}")
    assert port["argument_bytes"] == ref["argument_bytes"]
    assert 8 * port["matmul"] >= port["whole_matmul"]
    assert 0.5 <= coll <= 2.0
    if step == "dlrm":
        assert 0.98 <= matmul <= 1.02
    else:
        # the port's LM step splits its matmuls over the 8 ranks (but the
        # MoE router's, whose tokens lie over the fsdp axes alone); GSPMD's
        # partition of the reference's repeats some across the model axis
        # (the attention tiles whole over it): 0.82-0.87 of XLA's.  Both
        # move weights by all-gather; XLA moves the queries, keys and
        # values between sequence and head shards by all-to-all, the port
        # the queries only (it gathers keys and values): 0.41-0.44 of
        # XLA's all-to-all bytes (PERF.md §6 gives every ratio)
        assert 8 * port["matmul"] <= 1.05 * port["whole_matmul"]
        assert 0.8 <= matmul <= 1.0
        assert 0.5 <= ratio["all-gather"] <= 2.0
        assert 0.35 <= ratio["all-to-all"] <= 2.0


# --------------------------------------------------------------------- #
# (e) no work dropped
# --------------------------------------------------------------------- #
def _port_count(arch_id, shape, ov, mesh):
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import sharded_scope

    built = registry.get(arch_id).build(shape, ov)
    with sharded_scope(mesh):
        _, rec = count.measure(built.fn, built.make_inputs("meta", 0, mesh),
                               "meta")
    _, whole = count.measure(built.fn, built.make_inputs("meta", 0), "meta")
    return rec, whole


@pytest.fixture(scope="module")
def small_mesh():
    from repro_torch.launch.mesh import make_fake_mesh, release_fake_world

    yield make_fake_mesh(*SMALL["2x4"])
    release_fake_world()


def _smoke(mod):
    s = importlib.import_module("repro_torch.configs." + mod).SMOKE
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.name != "name"}


SMOKE_CELLS = [
    *[(a, shape, dict(_smoke(m), seq=64, batch=8))
      for a, m in LM_ARCHS.items()
      for shape in ("train_4k", "prefill_32k", "decode_32k")],
    ("gemma3-1b", "long_500k", dict(_smoke("gemma3_1b"), seq=64, batch=1)),
    *[("dlrm-mlperf", shape, _smoke("dlrm_mlperf"))
      for shape in ("train_batch", "serve_p99", "retrieval_cand")],
]


@pytest.mark.parametrize("arch_id,shape,ov", SMOKE_CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in SMOKE_CELLS])
def test_no_work_dropped(small_mesh, arch_id, shape, ov):
    rec, whole = _port_count(arch_id, shape, ov, small_mesh)
    assert (8 * rec["flops_by_class"]["matmul"]
            >= whole["flops_by_class"]["matmul"])
    assert rec["memory"]["argument_bytes"] * 8 >= whole["memory"][
        "argument_bytes"]


# --------------------------------------------------------------------- #
# (f) collectives by their output bytes
# --------------------------------------------------------------------- #
def test_functional_collectives_count_their_output():
    from torch.distributed._functional_collectives import (
        all_gather_tensor, wait_tensor)
    from torch.distributed.tensor import DTensor, Shard, placement_types

    from repro_torch.launch.mesh import make_fake_mesh, release_fake_world

    mesh = make_fake_mesh((16,), ("model",))
    try:
        shard = torch.empty(4, 512, device="meta")
        with count.WorkCounter() as wc:
            wait_tensor(all_gather_tensor(shard, 0, (mesh, 0)))
        assert wc.collectives == {"all-gather": 16 * 4 * 512 * 4}
        assert wc.collective_ops == [("all-gather", 16 * 4 * 512 * 4)]
        assert wc.bytes == 0

        x = DTensor.from_local(torch.empty(4, 512, device="meta"), mesh,
                               (Shard(0),), run_check=False,
                               shape=(64, 512), stride=(512, 1))
        prop = DTensor._op_dispatcher.sharding_propagator
        before = (dict(vars(prop)), placement_types.shard_dim_alltoall)
        with count.capture_dtensor(), count.WorkCounter() as wc:
            with count.capture_dtensor():     # nested: restored once
                y = x.redistribute(mesh, (Shard(1),))
        assert y.to_local().shape == (64, 32)
        assert wc.collective_ops == [("all-to-all", 64 * 32 * 4)]
        assert wc.bytes == 0
        assert (dict(vars(prop)), placement_types.shard_dim_alltoall) == (
            before)
    finally:
        release_fake_world()
