"""The dry-run's FLOPs by op class against the reference's: XLA's cost
analysis of the reference's programs (``repro.launch.dryrun`` reads
``compiled.cost_analysis()``), split by op class (``_xla_cost.split``),
against the port's work counter (``repro_torch.analysis.count``).

Op by op the port's formulas equal XLA's count of the ``jnp`` op the
reference writes.  A whole SMOKE step of each family is held class by
class to the reference's step as lowered, before XLA's passes (the
program as written), within the bands of :data:`BANDS`, and its total to
the compiled step's count, the one the reference's dry-run reads, within
[0.8, 1.25]: XLA:CPU's fusion copies cheap elementwise producers into
each consumer and counts every copy, so the compiled count holds more
elementwise FLOPs than the program writes.  ``pytest -s`` prints each
ratio and the elementwise FLOPs by op on both sides."""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.analysis import count
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun

from _torch_jax import _release_jax_programs  # noqa: F401
from _xla_cost import CLASSES, compiled_cost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_count(fn, *args):
    """The port's count of ``fn(*args)``: {class: FLOPs,
    "transcendentals": n}, the hand kernels' operations under ``kernel``."""
    with count.WorkCounter() as wc:
        fn(*args)
    return dict(wc.flops_by_class, transcendentals=wc.transcendentals)


def _assert_xla_totals(classes, totals):
    """The split reproduces ``cost_analysis()``'s totals (XLA sums in
    float32)."""
    assert sum(classes[c] for c in CLASSES) == pytest.approx(
        totals["flops"], rel=1e-5)
    assert classes["transcendentals"] == pytest.approx(
        totals["transcendentals"], rel=1e-5)


_rng = np.random.default_rng(0)
X = _rng.uniform(0.1, 0.9, (100, 10)).astype(np.float32)
Y = _rng.uniform(0.1, 0.9, (100, 10)).astype(np.float32)
W = _rng.uniform(-1, 1, (10, 6)).astype(np.float32)
I = np.arange(1000, dtype=np.int32)

#: (name, the port's op on torch tensors, the reference's on jnp arrays),
#: both of (x, y) [100, 10] float32 in (0.1, 0.9).
OPS = [
    ("add", lambda a, b: a + b, lambda a, b: a + b),
    ("sub", lambda a, b: a - b, lambda a, b: a - b),
    ("mul", lambda a, b: a * b, lambda a, b: a * b),
    ("div", lambda a, b: a / b, lambda a, b: a / b),
    ("neg", lambda a, b: -a, lambda a, b: -a),
    ("abs", lambda a, b: torch.abs(a - b), lambda a, b: jnp.abs(a - b)),
    ("maximum", torch.maximum, jnp.maximum),
    ("minimum", torch.minimum, jnp.minimum),
    ("where", lambda a, b: torch.where(a > b, a, b),
     lambda a, b: jnp.where(a > b, a, b)),
    ("clamp", lambda a, b: torch.clamp(a, 0.2, 0.8),
     lambda a, b: jnp.clip(a, 0.2, 0.8)),
    ("relu", lambda a, b: torch.relu(a - b), lambda a, b: jax.nn.relu(a - b)),
    ("reciprocal", lambda a, b: torch.reciprocal(a), lambda a, b: 1.0 / a),
    ("to_bfloat16", lambda a, b: a.to(torch.bfloat16),
     lambda a, b: a.astype(jnp.bfloat16)),
    ("exp", lambda a, b: torch.exp(a), lambda a, b: jnp.exp(a)),
    ("log", lambda a, b: torch.log(a), lambda a, b: jnp.log(a)),
    ("log1p", lambda a, b: torch.log1p(a), lambda a, b: jnp.log1p(a)),
    ("sqrt", lambda a, b: torch.sqrt(a), lambda a, b: jnp.sqrt(a)),
    ("rsqrt", lambda a, b: torch.rsqrt(a), lambda a, b: jax.lax.rsqrt(a)),
    ("sin", lambda a, b: torch.sin(a), lambda a, b: jnp.sin(a)),
    ("cos", lambda a, b: torch.cos(a), lambda a, b: jnp.cos(a)),
    ("tanh", lambda a, b: torch.tanh(a), lambda a, b: jnp.tanh(a)),
    ("atan2", torch.atan2, jnp.arctan2),
    ("sigmoid", lambda a, b: torch.sigmoid(a),
     lambda a, b: jax.nn.sigmoid(a)),
    ("silu", lambda a, b: F.silu(a), lambda a, b: jax.nn.silu(a)),
    ("acos", lambda a, b: torch.acos(a), lambda a, b: jnp.arccos(a)),
    *[(f"pow{e}", lambda a, b, e=e: a ** e, lambda a, b, e=e: a ** e)
      for e in (2, 5, 6, 7, -1, 0.5, 2.5)],
    ("pow_tensor", lambda a, b: a ** b, lambda a, b: a ** b),
    ("sum", lambda a, b: a.sum(-1), lambda a, b: a.sum(-1)),
    ("mean", lambda a, b: a.mean(-1), lambda a, b: a.mean(-1)),
    ("amax", lambda a, b: torch.amax(a, -1), lambda a, b: a.max(-1)),
    ("logsumexp", lambda a, b: torch.logsumexp(a, -1),
     lambda a, b: jax.nn.logsumexp(a, -1)),
    ("softmax", lambda a, b: torch.softmax(a, -1),
     lambda a, b: jax.nn.softmax(a, -1)),
    ("log_softmax", lambda a, b: torch.log_softmax(a, -1),
     lambda a, b: jax.nn.log_softmax(a, -1)),
    ("norm", lambda a, b: torch.linalg.vector_norm(a, dim=-1),
     lambda a, b: jnp.linalg.norm(a, axis=-1)),
    ("sort", lambda a, b: torch.sort(a, dim=-1, stable=True)[1],
     lambda a, b: jnp.argsort(a, -1, stable=True)),
    ("matmul", lambda a, b: a @ torch.from_numpy(W),
     lambda a, b: a @ jnp.asarray(W)),
]


@pytest.mark.parametrize("name,port_fn,ref_fn", OPS, ids=[o[0] for o in OPS])
def test_op_formula_equals_xla(name, port_fn, ref_fn):
    """Each of the port's formulas gives, class by class, what XLA's cost
    analysis counts for the reference's ``jnp`` op on the same shapes."""
    xla = compiled_cost(ref_fn, X, Y)
    want = xla["compiled"][0]
    _assert_xla_totals(want, xla["totals"])
    got = _port_count(port_fn, torch.from_numpy(X), torch.from_numpy(Y))
    assert got["kernel"] == 0
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("name,port_fn,ref_fn", [
    ("floor_divide", lambda i: i // 7, lambda i: i // 7),
    ("remainder", lambda i: i % 7, lambda i: i % 7)])
def test_integer_division_equals_xla(name, port_fn, ref_fn):
    """Integer ``//`` and ``%`` count the sign fixes ``jnp`` adds."""
    xla = compiled_cost(ref_fn, I)
    want = xla["compiled"][0]
    _assert_xla_totals(want, xla["totals"])
    got = _port_count(port_fn, torch.from_numpy(I))
    assert {k: got[k] for k in want} == want


def test_scatter_add_combiner_equals_xla():
    """A scatter-add costs its combiner once a source element, in the
    reduction class (XLA also counts ``jnp``'s index checks, which the
    port's ``index_add`` does not make)."""
    idx = np.arange(100) % 7
    xla = compiled_cost(lambda a, i: jnp.zeros((7, 10)).at[i].add(a), X,
                        idx)
    want = xla["compiled"][0]
    _assert_xla_totals(want, xla["totals"])
    got = _port_count(lambda a, i: torch.zeros(7, 10).index_add(0, i, a),
                      torch.from_numpy(X), torch.from_numpy(idx))
    assert got["reduction"] == want["reduction"] == X.size


def test_layout_ops_count_no_flops():
    """Views, copies, concatenation, indexing and factories count 0, as
    XLA counts its layout and data-movement ops."""
    x = torch.from_numpy(X)
    idx = torch.arange(50) * 2
    got = _port_count(lambda: (x.clone(), torch.cat([x, x]), x[idx],
                               x.t().contiguous(), torch.zeros(5),
                               torch.stack([x, x]), x.reshape(-1)[3:]))
    assert got == dict.fromkeys(count.FLOP_CLASSES + ("transcendentals",), 0)


# --------------------------------------------------------------------- #
# SMOKE cells, whole steps
# --------------------------------------------------------------------- #
#: (arch, shape, config module, the LMs' seq and batch cut).
CELLS = [
    ("qwen3-32b", "train_4k", "qwen3_32b", dict(seq=32, batch=2)),
    ("qwen3-moe-235b-a22b", "train_4k", "qwen3_moe_235b",
     dict(seq=32, batch=2)),
    ("gatedgcn", "molecule", "gatedgcn_cfg", None),
    ("dlrm-mlperf", "train_batch", "dlrm_mlperf", None),
]
#: port / XLA bands of a SMOKE step, each class against the step as
#: lowered.  Both programs write the same dots, reductions and scatters:
#: matmul is equal, total and reduction within 2 %.  Elementwise within
#: 5 %: torch's autograd and JAX's autodiff write some backward formulas
#: differently (a mean's backward divides every input element in torch,
#: every output element in JAX; JAX's relu and ``where`` cotangents select
#: every element).  Transcendentals from 1 to 1.15: torch's backward
#: recomputes what JAX keeps from the forward (``silu_backward`` its
#: sigmoid).  The compiled total, the reference's dry-run reading, within
#: [0.8, 1.25].
BANDS = {"matmul": (1.0, 1.0), "total": (0.98, 1.02),
         "reduction": (0.98, 1.02), "elementwise": (0.95, 1.05),
         "transcendentals": (1.0, 1.15), "total_compiled": (0.8, 1.25)}
#: Hand kernels that are a scatter-add in the reference (XLA's
#: ``scatter``: the reduction class).
SCATTER_KERNELS = ("segment_sum", "segment_fused", "embedding_bag_backward")
#: Hand kernels that are ``jnp.take`` in the reference: a gather (0) whose
#: out-of-range fill selects every output element (the elementwise class);
#: the kernel's formula counts one multiply an output element (the
#: weight that carries the fill).
TAKE_KERNELS = ("embedding_bag",)


def _smoke(module) -> dict:
    s = module.SMOKE
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.name != "name"}


def _reference_count(monkeypatch, arch_id, shape, mod_name, cut):
    """The reference's dry-run count of the cell at its SMOKE config: the
    step its ``build`` makes, jitted on its abstract inputs over a
    one-device mesh, layer scans unrolled as its probes unroll them."""
    jm = importlib.import_module("repro.configs." + mod_name)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    if arch_id == "dlrm-mlperf":         # dlrm_build takes no overrides
        built = jbase.dlrm_build(jm.SMOKE, shape, mesh, ("data",))
    else:
        if cut:
            monkeypatch.setitem(jbase.LM_SHAPES, shape,
                                dict(jbase.LM_SHAPES[shape], **cut))
        built = jreg.get(arch_id).build(shape, mesh, ("data",),
                                        dict(_smoke(jm), probe_unroll=True))
    return compiled_cost(built.fn, *built.abstract_inputs,
                         in_shardings=built.in_shardings)


def class_ratios(port: dict, xla: dict) -> dict:
    """port / XLA a class (see :data:`BANDS`), against the lowered step
    but ``total_compiled``."""
    lowered, compiled = xla["lowered"][0], xla["compiled"][0]
    p_cls = port["flops_by_class"]

    def ops(names):
        return sum(port["kernels"].get(k, {}).get("ops", 0) for k in names)

    return {
        "matmul": p_cls["matmul"] / lowered["matmul"],
        "total": port["flops"] / sum(lowered[c] for c in CLASSES),
        "reduction": ((p_cls["reduction"] + ops(SCATTER_KERNELS))
                      / lowered["reduction"]),
        "elementwise": ((p_cls["elementwise"] + ops(TAKE_KERNELS))
                        / lowered["elementwise"]),
        "transcendentals": (port["transcendentals"]
                            / lowered["transcendentals"]),
        "total_compiled": port["flops"] / sum(compiled[c] for c in CLASSES),
    }


@pytest.mark.parametrize("arch_id,shape,mod_name,cut", CELLS,
                         ids=[c[0] for c in CELLS])
def test_smoke_cell_flops_by_class_against_xla(monkeypatch, arch_id, shape,
                                                mod_name, cut):
    """A SMOKE training step counted by the port on meta against XLA's
    count of the reference's step, class by class, within :data:`BANDS`;
    the port's FLOPs add up from its classes and its transcendentals are
    not among them; XLA's fusion adds elementwise FLOPs, never drops
    them."""
    xla = _reference_count(monkeypatch, arch_id, shape, mod_name, cut)
    _assert_xla_totals(xla["compiled"][0], xla["totals"])
    tm = importlib.import_module("repro_torch.configs." + mod_name)
    built = treg.get(arch_id).build(shape, {**_smoke(tm), **(cut or {})})
    _, port = count.measure(built.fn, built.make_inputs("meta", 0), "meta")
    assert port["flops"] == sum(port["flops_by_class"].values())
    assert port["transcendentals"] > 0
    lowered, compiled = xla["lowered"][0], xla["compiled"][0]
    assert compiled["elementwise"] >= lowered["elementwise"]
    ratios = class_ratios(port, xla)
    print(f"\n{arch_id} × {shape} SMOKE, port / XLA: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ratios.items())
        + f"; XLA's elementwise FLOPs compiled / lowered "
        f"{compiled['elementwise'] / lowered['elementwise']:.4f}")
    print("  XLA elementwise by opcode, lowered (compiled): " + ", ".join(
        f"{op} {n:.0f} ({xla['compiled'][1].get(op, 0):.0f})"
        for op, n in sorted(xla["lowered"][1].items(), key=lambda kv: -kv[1])))
    print("  port by op [flops, transcendentals]: " + ", ".join(
        f"{op.removeprefix('aten.')} [{v[1]}, {v[3]}]"
        for op, v in sorted(port["by_op"].items(),
                            key=lambda kv: -kv[1][1] - kv[1][3])
        if v[1] or v[3]) + f"; kernels {port['kernels']}")
    for k, (lo, hi) in BANDS.items():
        assert lo <= ratios[k] <= hi, (k, ratios[k], port["flops_by_class"],
                                       lowered)


def test_record_carries_transcendentals_and_classes():
    """A dry-run record carries the transcendentals beside the FLOPs and
    the FLOPs by class, per device, and they add up to its FLOPs; ops
    that count only transcendentals are not listed as without FLOPs."""
    ov = {**_smoke(importlib.import_module(
        "repro_torch.configs.gemma3_1b")), "seq": 64, "batch": 2}
    cell = dryrun.run_cell("gemma3-1b", "train_4k", overrides=ov)
    assert cell["counted_on"] == "meta"
    probe = cell["probes"][0]
    assert "aten.exp.default" not in probe["ops_without_flops"]
    assert "aten.cat.default" in probe["ops_without_flops"]
    for mesh, chips in dryrun.MESH_CHIPS.items():
        rec = dryrun.mesh_record("gemma3-1b", "train_4k", mesh, cell,
                                 cell["total"], dryrun.device_info("meta"))
        assert rec["transcendentals"] == pytest.approx(
            cell["total"]["transcendentals"] / chips)
        assert sum(rec["flops_by_class"].values()) == pytest.approx(
            rec["cost"]["flops"])
        assert set(rec["flops_by_class"]) == set(count.FLOP_CLASSES)
        assert "transcendentals/dev=" in dryrun.summary_line(rec)
