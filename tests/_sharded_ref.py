"""The reference's side of ``tests/test_torch_sharded.py``, run in a
subprocess of its own: JAX must see its host devices (``XLA_FLAGS``) before
it is first imported, and each side of a comparison gets a process.

  python tests/_sharded_ref.py shards N     # every LM and DLRM cell
  python tests/_sharded_ref.py small SHAPE AXES ARCH
  python tests/_sharded_ref.py port-shards MULTI
  python tests/_sharded_ref.py port-small SHAPE AXES ARCH
  python tests/_sharded_ref.py gnn-shards N     # every GNN cell
  python tests/_sharded_ref.py port-gnn-shards MULTI
  python tests/_sharded_ref.py gnn-small ARCH SHAPE OVERRIDES
  python tests/_sharded_ref.py port-gnn-small ARCH SHAPE OVERRIDES
  python tests/_sharded_ref.py gloo-gnn CELLS

``shards``: on N host devices, each cell's in_shardings on both production
meshes as (global shape, shard shape) of every input leaf, in the
reference's flatten order (the decode step's scalar cache length left
out).  ``small``: one SMOKE training step compiled with its shardings on
an 8-device host mesh: its per-device argument bytes, matmul FLOPs
(``_xla_cost.split``), collective bytes by kind (``hlo.py``) and its
all-reduces' bytes over their group sizes (``all_reduce_shard_bytes``:
the output of a reduce-scatter of the same tensors).  The ``port-*``
commands print the port's counterparts from a fake process group of as
many ranks (``repro_torch`` only; no JAX in that process).  Each prints
one JSON object as its last line.

The ``gnn-*`` commands do the same for the GNN cells: ``gnn-small`` and
``port-gnn-small`` take a GNN arch's SMOKE config with OVERRIDES (JSON;
the reference's scans unrolled, so that XLA's text holds every layer's
and chunk's ops) at one of its shapes on the (data 2, model 4) mesh, the
port counting the argument bytes of the inputs its program reads, as
XLA's do.  ``gloo-gnn`` runs each cell of CELLS (JSON [[arch, shape,
overrides], ...]) as the port's SMOKE training step on a real 4-rank
gloo group of CPU processes, a (data 2, model 2) ``DeviceMesh``, and
prints its loss and its gradients gathered whole beside the unsharded
step's on the same seed.

The LM steps run in float32 on both sides: XLA:CPU runs a bf16 step's
collectives in f32 (every one of the bf16 SMOKE step's), where the port
moves bf16 as bf16.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import sys

#: The LM cells' SMOKE training step: the seq and batch it runs at (every
#: small mesh's axes divide them), in float32 (see above).
SMOKE_CUT = dict(seq=64, batch=8)
#: SMOKE steps held against the reference: (name, config module).
SMOKE_STEPS = {"dense": "qwen3_32b", "moe": "qwen3_moe_235b",
               "dlrm": "dlrm_mlperf"}


def _smoke_overrides(module) -> dict:
    s = module.SMOKE
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.name != "name"}


#: The GNN archs' config modules.
GNN_MODULES = {"graphsage-reddit": "graphsage_reddit",
               "gatedgcn": "gatedgcn_cfg", "dimenet": "dimenet_cfg",
               "equiformer-v2": "equiformer_v2_cfg"}


def _cells(family_of, families=("lm", "recsys")):
    return [(a, s) for a, s, _ in family_of.all_cells(include_skipped=False)
            if family_of.get(a).family in families]


def ref_shards(n_devices: int, families=("lm", "recsys")) -> dict:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_devices}")
    import jax

    from repro.configs import base, registry
    from repro.launch.mesh import make_production_mesh
    from repro.models import common as MC

    out = {}
    for kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=kind == "multi")
        MC.set_hint_mesh(mesh)
        fsdp = base.fsdp_axes_for(mesh)
        for arch_id, shape in _cells(registry, families):
            built = registry.get(arch_id).build(shape, mesh, fsdp)
            shardings = jax.tree.leaves(built.in_shardings)
            leaves = jax.tree.leaves(built.abstract_inputs)
            if base.LM_SHAPES.get(shape, {}).get("kind") == "decode":
                shardings, leaves = shardings[:-1], leaves[:-1]
            out[f"{arch_id}/{shape}/{kind}"] = [
                [list(x.shape), list(sh.shard_shape(x.shape))]
                for x, sh in zip(leaves, shardings, strict=True)]
        MC.set_hint_mesh(None)
    return out


def port_shards(multi: bool, families=("lm", "recsys")) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import optimizer as opt

    mesh = make_production_mesh(multi_pod=multi)
    kind = "multi" if multi else "single"
    out = {}
    for arch_id, shape in _cells(registry, families):
        inputs = registry.get(arch_id).build(shape).make_inputs(
            "meta", 0, mesh)
        inputs = [{k: v for k, v in x.items()
                   if k not in ("host", "host_whole")}
                  if isinstance(x, dict) and "host" in x else x
                  for x in inputs]
        out[f"{arch_id}/{shape}/{kind}"] = [
            [list(t.shape), list(t.to_local().shape)]
            for t in opt.leaves(inputs) if isinstance(t, DTensor)]
    return out


def ref_small(mesh_shape, axes, step: str) -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np

    from repro.analysis import hlo
    from repro.configs import base, registry
    from repro.models import common as MC

    sys.path.insert(0, os.path.dirname(__file__))
    from _xla_cost import split

    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:8]).reshape(mesh_shape), tuple(axes))
    MC.set_hint_mesh(mesh)
    fsdp = base.fsdp_axes_for(mesh)
    module = importlib.import_module("repro.configs." + SMOKE_STEPS[step])
    if step == "dlrm":
        built = base.dlrm_build(module.SMOKE, "train_batch", mesh, fsdp)
    else:
        base.LM_SHAPES["train_4k"] = dict(base.LM_SHAPES["train_4k"],
                                          **SMOKE_CUT)
        built = registry.get(module.ARCH.arch_id).build(
            "train_4k", mesh, fsdp,
            dict(_smoke_overrides(module), probe_unroll=True,
                 dtype=jax.numpy.float32))
    compiled = jax.jit(built.fn, in_shardings=built.in_shardings,
                       out_shardings=built.out_shardings).lower(
        *built.abstract_inputs).compile()
    # hlo.py's shape pattern stops at the "/*index=N*/" comments XLA puts
    # in long tuple shapes (a combined all-reduce of every gradient)
    text = re.sub(r"/\*index=\d+\*/", "", compiled.as_text())
    classes, _ = split(text)
    return dict(argument_bytes=compiled.memory_analysis()
                .argument_size_in_bytes,
                matmul=classes["matmul"],
                collectives=hlo.collective_bytes(text),
                all_reduce_shard_bytes=sum(
                    hlo._shape_bytes(shape) / _group_size(line, 8)
                    for shape, line in _ops(text, "all-reduce")))


def _ops(text: str, kind: str):
    """(output shape text, the op's line) of each ``kind`` op of the HLO
    text (``hlo.py``'s pattern)."""
    from repro.analysis import hlo

    for m in hlo._OP_RE.finditer(text):
        if m.group(2) == kind:
            yield m.group(1), text[m.start():text.find("\n", m.start())]


def _group_size(line: str, n_devices: int) -> int:
    """The size of a collective's replica groups, in either of XLA's
    notations (``[groups,size]<=[...]`` or ``{{a,b,...},...}``; none
    listed: every device)."""
    m = re.search(r"replica_groups=\[\d+,(\d+)\]", line)
    if m:
        return int(m.group(1))
    m = re.search(r"replica_groups=\{\{([\d,]*)\}", line)
    return len(m.group(1).split(",")) if m else n_devices


def port_small(mesh_shape, axes, step: str) -> dict:
    import torch

    from repro_torch.analysis import count
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import sharded_scope
    from repro_torch.launch.mesh import make_fake_mesh

    mesh = make_fake_mesh(mesh_shape, axes)
    module = importlib.import_module(
        "repro_torch.configs." + SMOKE_STEPS[step])
    ov = _smoke_overrides(module)
    if step == "dlrm":
        built = registry.get("dlrm-mlperf").build("train_batch", ov)
    else:
        built = registry.get(module.ARCH.arch_id).build(
            "train_4k", dict(ov, **SMOKE_CUT, dtype=torch.float32))
    with sharded_scope(mesh):
        _, rec = count.measure(built.fn, built.make_inputs("meta", 0, mesh),
                               "meta")
    _, whole = count.measure(built.fn, built.make_inputs("meta", 0), "meta")
    return dict(argument_bytes=rec["memory"]["argument_bytes"],
                matmul=rec["flops_by_class"]["matmul"],
                whole_matmul=whole["flops_by_class"]["matmul"],
                collectives=rec["collectives"])


def _gnn_smoke(package: str, arch: str, overrides: dict) -> dict:
    module = importlib.import_module(f"{package}.configs.{GNN_MODULES[arch]}")
    return dict(_smoke_overrides(module), **overrides)


def ref_gnn_small(arch: str, shape: str, overrides: dict) -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np

    from repro.analysis import hlo
    from repro.configs import base, registry
    from repro.models import common as MC

    sys.path.insert(0, os.path.dirname(__file__))
    from _xla_cost import split

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                             ("data", "model"))
    MC.set_hint_mesh(mesh)
    ov = _gnn_smoke("repro", arch, dict(overrides, probe_unroll=True))
    built = registry.get(arch).build(shape, mesh, base.fsdp_axes_for(mesh),
                                     ov)
    compiled = jax.jit(built.fn, in_shardings=built.in_shardings,
                       out_shardings=built.out_shardings).lower(
        *built.abstract_inputs).compile()
    text = re.sub(r"/\*index=\d+\*/", "", compiled.as_text())
    classes, _ = split(text)
    return dict(argument_bytes=compiled.memory_analysis()
                .argument_size_in_bytes,
                matmul=classes["matmul"],
                collectives=hlo.collective_bytes(text),
                all_reduce_shard_bytes=sum(
                    hlo._shape_bytes(shape) / _group_size(line, 8)
                    for shape, line in _ops(text, "all-reduce")))


def port_gnn_small(arch: str, shape: str, overrides: dict) -> dict:
    import torch

    from repro_torch.analysis import count
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import sharded_scope
    from repro_torch.launch.mesh import make_fake_mesh

    torch.set_num_threads(1)
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    built = registry.get(arch).build(
        shape, _gnn_smoke("repro_torch", arch, overrides))
    with sharded_scope(mesh):
        _, rec = count.measure(built.fn, built.make_inputs("meta", 0, mesh),
                               "meta", read_only=True)
    _, whole = count.measure(built.fn, built.make_inputs("meta", 0), "meta",
                             read_only=True)
    return dict(argument_bytes=rec["memory"]["argument_bytes"],
                whole_argument_bytes=whole["memory"]["argument_bytes"],
                matmul=rec["flops_by_class"]["matmul"],
                whole_matmul=whole["flops_by_class"]["matmul"],
                collectives=rec["collectives"])


def _gloo_rank(rank: int, world: int, init: str, cells, out: str) -> None:
    """One rank of ``gloo-gnn``: each cell's sharded step on the (data 2,
    model 2) mesh and, on rank 0, the unsharded step beside it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import sharded_scope
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import loss_and_grads

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for arch, shape, overrides in cells:
        module = importlib.import_module(
            f"repro_torch.configs.{GNN_MODULES[arch]}").module
        built = registry.get(arch).build(
            shape, _gnn_smoke("repro_torch", arch, overrides))
        kw = dict(model_cls=module.MODEL, loss_fn=module.loss_fn)
        params, _, batch = built.make_inputs("cpu", 0, mesh)
        with sharded_scope(mesh):
            loss, grads = loss_and_grads(params, batch, built.cfg, **kw)
            whole = [g.full_tensor() if isinstance(g, DTensor) else g
                     for g in opt.leaves(grads)]
            if isinstance(loss, DTensor):
                loss = loss.full_tensor()
        if rank == 0:
            params, _, batch = built.make_inputs("cpu", 0)
            loss0, grads0 = loss_and_grads(params, batch, built.cfg, **kw)
            res[arch] = dict(loss=float(loss), loss0=float(loss0),
                             grads=[g.tolist() for g in whole],
                             grads0=[g.tolist() for g in opt.leaves(grads0)])
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(res, fh)
    dist.destroy_process_group()


def gloo_gnn(cells) -> dict:
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        mp.spawn(_gloo_rank, nprocs=4, args=(
            4, "file://" + os.path.join(tmp, "rendezvous"), cells, out))
        with open(out) as fh:
            return json.load(fh)


if __name__ == "__main__":
    cmd, *args = sys.argv[1:]
    if cmd == "shards":
        res = ref_shards(int(args[0]))
    elif cmd == "port-shards":
        res = port_shards(args[0] == "multi")
    elif cmd == "gnn-shards":
        res = ref_shards(int(args[0]), ("gnn",))
    elif cmd == "port-gnn-shards":
        res = port_shards(args[0] == "multi", ("gnn",))
    elif cmd == "gnn-small":
        res = ref_gnn_small(args[0], args[1], json.loads(args[2]))
    elif cmd == "port-gnn-small":
        res = port_gnn_small(args[0], args[1], json.loads(args[2]))
    elif cmd == "gloo-gnn":
        res = gloo_gnn(json.loads(args[0]))
    elif cmd == "small":
        res = ref_small(json.loads(args[0]), json.loads(args[1]), args[2])
    else:
        res = port_small(json.loads(args[0]), json.loads(args[1]), args[2])
    print(json.dumps(res))
