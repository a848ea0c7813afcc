"""The reference's side of ``tests/test_torch_sharded.py``, run in a
subprocess of its own: JAX must see its host devices (``XLA_FLAGS``) before
it is first imported, and each side of a comparison gets a process.

  python tests/_sharded_ref.py shards N     # every LM and DLRM cell
  python tests/_sharded_ref.py small SHAPE AXES ARCH
  python tests/_sharded_ref.py port-shards MULTI
  python tests/_sharded_ref.py port-small SHAPE AXES ARCH

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


def _cells(family_of):
    return [(a, s) for a, s, _ in family_of.all_cells(include_skipped=False)
            if family_of.get(a).family in ("lm", "recsys")]


def ref_shards(n_devices: int) -> dict:
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
        for arch_id, shape in _cells(registry):
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


def port_shards(multi: bool) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import optimizer as opt

    mesh = make_production_mesh(multi_pod=multi)
    kind = "multi" if multi else "single"
    out = {}
    for arch_id, shape in _cells(registry):
        inputs = registry.get(arch_id).build(shape).make_inputs(
            "meta", 0, mesh)
        inputs = [{k: v for k, v in x.items() if k != "host"}
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


if __name__ == "__main__":
    cmd, *args = sys.argv[1:]
    if cmd == "shards":
        res = ref_shards(int(args[0]))
    elif cmd == "port-shards":
        res = port_shards(args[0] == "multi")
    elif cmd == "small":
        res = ref_small(json.loads(args[0]), json.loads(args[1]), args[2])
    else:
        res = port_small(json.loads(args[0]), json.loads(args[1]), args[2])
    print(json.dumps(res))
