"""Port parity of the dry-run: the arch registry and its shape tables, the
model FLOPs of every cell, the work counter (``analysis/count.py``), the
probes' extrapolation, the report tables, the per-PE sweep-round probe and
the CLI, against the reference (``repro.configs``, ``repro.analysis``,
``repro.core.solvers.sweep_probe_shard_map_fn``) on the CPU.

The reference's constants are TPU v5e's; where its numbers are compared,
its ``roofline`` module's constants are set to the port's (H100) with
``monkeypatch``.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import extrapolate as jex
from repro.analysis import report as jrep
from repro.analysis import roofline as jrl
from repro.configs import registry as jreg
from repro_torch.analysis import count
from repro_torch.analysis import extrapolate as tex
from repro_torch.analysis import report as trep
from repro_torch.analysis import roofline as trl
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen3_32b
from repro_torch.configs import registry as treg
from repro_torch.core import distributed as TD
from repro_torch.core import partition as tpart
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import Work
from repro_torch.kernels.embedding_bag.cost import (
    embedding_bag_bwd_work, embedding_bag_work,
)
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.segment_coo.cost import (
    segment_fused_work, segment_sum_work,
)
from repro_torch.kernels.segment_coo.ops import (
    pack_blocks, segment_fused_coo, segment_sum_coo,
)
from repro_torch.kernels.wedge_intersect.cost import wedge_intersect_work
from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
from repro_torch.launch import dryrun, mesh

from _torch_jax import _release_jax_programs  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
#: the sweep-round probe's instance (n <= 500) and config
P, N, WINDOW_CAP, HEAVY_K = 4, 400, 8, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so torch's pool does not fight JAX's (and the
    other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# configs and registry
# --------------------------------------------------------------------- #
def test_registry_matches_reference():
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    for arch_id, want in jreg.ARCHS.items():
        got = treg.get(arch_id)
        assert (got.family, got.shapes, got.skips) == (
            want.family, want.shapes, want.skips), arch_id
    assert treg.all_cells(True) == jreg.all_cells(True)
    assert treg.all_cells() == jreg.all_cells()
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("nope")


def test_shape_tables_match_reference():
    from repro.configs import base as jbase

    assert tbase.LM_SHAPES == jbase.LM_SHAPES
    assert tbase.GNN_SHAPES == jbase.GNN_SHAPES
    assert tbase.RECSYS_SHAPES == jbase.RECSYS_SHAPES
    assert tbase.MWIS_SHAPES == jbase.MWIS_SHAPES
    assert tbase.pad_multiple(1000) == jbase.pad_multiple(1000)


@pytest.fixture(scope="module")
def host_mesh():
    """A one-device mesh for the reference's builders (their model FLOPs
    do not depend on it)."""
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch_id,shape", [
    (a, s) for a, s, _ in jreg.all_cells()])
def test_model_flops_match_reference(host_mesh, arch_id, shape):
    """Every cell's model FLOPs are the reference's formula at the same
    shape; MWIS's is 10·p·E (the reference's p is its mesh's PE count, the
    port's the ranks it counts on)."""
    got = treg.get(arch_id).build(shape)
    if arch_id == "mwis":
        assert got.model_flops == 10.0 * 4 * tbase.MWIS_SHAPES[shape]["E"]
        return
    want = jreg.get(arch_id).build(shape, host_mesh, ("data",))
    assert got.model_flops == want.model_flops
    assert got.note == want.note


# --------------------------------------------------------------------- #
# the work counter
# --------------------------------------------------------------------- #
def test_counter_matmul_add_and_view():
    """A matmul's 2 · multiply-adds (matmul class), an add's FLOP an
    element (elementwise class, as XLA counts it), views nothing."""
    a, b, c = torch.randn(3, 4), torch.randn(4, 5), torch.randn(3, 5)
    with count.WorkCounter() as wc:
        d = a @ b
    assert (wc.flops, wc.bytes) == (2 * 3 * 4 * 5, 4 * (12 + 20 + 15))
    assert wc.flops_by_class["matmul"] == wc.flops
    with count.WorkCounter() as wc:
        e = d + c
    assert (wc.flops, wc.bytes) == (15, 3 * 4 * 15)
    assert wc.flops_by_class["elementwise"] == 15
    with count.WorkCounter() as wc:
        e.view(15)
        e.t()
        e[1:]
    assert (wc.flops, wc.bytes, wc.by_op) == (0, 0, {})


def test_counter_matrix_vector_and_dot_products():
    """``mv``, ``addmv``, ``dot`` and ``vdot``, which torch's formula
    registry lacks, count 2 · multiply-adds (the retrieval score
    ``cand @ d[0]`` is an ``mv``)."""
    m, v, w = torch.randn(7, 5), torch.randn(5), torch.randn(5)
    y = torch.randn(7)
    cases = [(lambda: m @ v, "aten.mv.default", 2 * 7 * 5),
             (lambda: torch.addmv(y, m, v), "aten.addmv.default", 2 * 7 * 5),
             (lambda: torch.dot(v, w), "aten.dot.default", 2 * 5),
             (lambda: torch.vdot(v, w), "aten.vdot.default", 2 * 5)]
    for call, op, flops in cases:
        with count.WorkCounter() as wc:
            call()
        assert wc.flops == flops and wc.by_op[op][1] == flops, op
    from torch.utils.flop_counter import flop_registry

    assert torch.ops.aten.mv not in flop_registry   # torch's stays as is


def _ops_cases():
    rng = np.random.default_rng(0)
    row = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    perm, lrow, _ = pack_blocks(row, 40, r_blk=8, e_blk_multiple=8)
    perm = torch.from_numpy(perm.astype(np.int32))
    lrow = torch.from_numpy(lrow)
    data = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    ints = torch.from_numpy(rng.integers(-99, 99, (300, 3)).astype(np.int32))
    table = torch.randn(50, 16)
    idx = torch.from_numpy(rng.integers(0, 50, (20, 3)).astype(np.int32))
    wgt = torch.rand(20, 3)
    window = torch.from_numpy(np.sort(rng.integers(0, 60, (61, 8)), 1)
                              .astype(np.int32))
    weights = torch.from_numpy(rng.integers(1, 9, 61).astype(np.int32))
    active = torch.from_numpy(rng.random(61) < 0.7)
    erow = torch.from_numpy(rng.integers(0, 61, 90).astype(np.int32))
    ecol = torch.from_numpy(rng.integers(0, 61, 90).astype(np.int32))
    grad = torch.randn(20, 16)
    table_g = table.clone().requires_grad_()
    out = embedding_bag(table_g, idx, wgt)     # the backward's forward
    return {
        "segment_sum": (lambda: segment_sum_coo(data, perm, lrow, 40),
                        segment_sum_work(data, perm, lrow, 40)),
        "segment_fused": (
            lambda: segment_fused_coo(perm, lrow, 40, data_sum=ints,
                                      data_or=ints[:, :1]),
            segment_fused_work(perm, lrow, 40, data_sum=ints,
                               data_or=ints[:, :1])),
        "embedding_bag": (lambda: embedding_bag(table, idx, wgt),
                          embedding_bag_work(table, idx, wgt)),
        "embedding_bag_backward": (
            lambda: torch.autograd.grad(out, table_g, grad),
            embedding_bag_bwd_work(grad, idx, wgt, 50)),
        "wedge_intersect": (
            lambda: common_neighbor_stats(window, weights, active, erow,
                                          ecol),
            wedge_intersect_work(window, weights, active, erow, ecol)),
    }


@pytest.mark.parametrize("kernel", ["segment_sum", "segment_fused",
                                    "embedding_bag", "embedding_bag_backward",
                                    "wedge_intersect"])
def test_counter_counts_a_kernel_op_by_its_formula(kernel):
    """A kernel op on CPU tensors counts one unit of its formula's work and
    none of its plain version's aten ops."""
    call, work = _ops_cases()[kernel]
    assert isinstance(work, Work) and work.ops > 0 and work.bytes > 0
    with count.WorkCounter() as wc:
        call()
    rec = wc.summary()["kernels"][kernel]
    assert rec == dict(units=1, ops=work.ops, op_class=work.op_class,
                       bytes=work.bytes)
    assert (wc.by_op, wc.flops, wc.bytes) == ({}, work.ops, work.bytes)


def test_formulas_count_live_slots_and_distinct_window_entries():
    lrow = torch.tensor([[0, 1, 8, 8], [3, 8, 8, 8]], dtype=torch.int32)
    perm = torch.zeros_like(lrow)
    data = torch.ones(5, 2)
    w = segment_sum_work(data, perm, lrow, 16)
    assert w == Work(3 * 2, "fp32_add", 4 * 8 + 4 * 3 + 4 * 2 * (3 + 16))
    window = torch.tensor([[1, 2, 9, 9], [0, 3, 4, 5]], dtype=torch.int32)
    edges = torch.tensor([0, 1], dtype=torch.int32)
    w = wedge_intersect_work(window, torch.ones(2, dtype=torch.int32),
                             torch.ones(2, dtype=torch.bool), edges,
                             edges.flip(0))
    assert w.ops == 2 * (3 + 4)


def test_measure_reports_memory_and_outputs():
    a = torch.randn(8, 8)
    out, rec = count.measure(lambda x: x @ x, (a,), "cpu")
    assert torch.equal(out, a @ a)
    assert rec["memory"] == dict(argument_bytes=256, output_bytes=256,
                                 temp_bytes=None)
    assert rec["flops"] == 2 * 8 ** 3 and rec["run_s"] >= 0


# --------------------------------------------------------------------- #
# extrapolation
# --------------------------------------------------------------------- #
def _smoke_count(kind_shape, n_layers, batch):
    ov = {f: getattr(qwen3_32b.SMOKE, f) for f in (
        "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
        "attn_chunk", "loss_chunks")}
    built = treg.get("qwen3-32b").build(kind_shape, dict(
        ov, n_layers=n_layers, batch=batch, seq=32))
    _, rec = count.measure(built.fn, built.make_inputs("cpu", 0), "cpu")
    terms = dryrun._terms(rec, {}, [])
    terms["by_op"] = {op: v[2] for op, v in rec["by_op"].items()}
    return terms


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_extrapolation_is_exact_for_uniform_layers(shape):
    """qwen3-32b at its SMOKE widths (uniform layers), seq 32: the counts at
    probes L 2, 4 × B 2, 4 extrapolate multilinearly to exactly the count
    of a run at L 6, B 3, every term and every op's bytes, in decode and
    in training: each stacked weight is cut into its layers once a
    forward (``common.layer_slices``), so its gradient's bytes are linear
    in L (an indexed slice a layer made them grow as L^2)."""
    samples = [({"n_layers": L, "batch": B}, _smoke_count(shape, L, B))
               for L in (2, 4) for B in (2, 4)]
    ops = {op for _, t in samples for op in t["by_op"]}
    for _, t in samples:
        t["by_op"] = {op: t["by_op"].get(op, 0) for op in ops}
    got = tex.multilinear(samples, {"n_layers": 6, "batch": 3})
    want = _smoke_count(shape, 6, 3)
    assert set(want["by_op"]) == ops
    assert "aten.select_backward.default" not in ops
    assert got == want


def test_multilinear_reference_form():
    """One axis at 2, 4 is the reference's t2 + (t4 - t2) / 2 · (L - 2)."""
    t2, t4 = 1234.5, 9876.25
    assert tex.multilinear([({"n_layers": 2}, t2), ({"n_layers": 4}, t4)],
                           {"n_layers": 40}) == t2 + (t4 - t2) / 2.0 * 38
    with pytest.raises(ValueError):
        tex.multilinear([({"n_layers": 2}, t2)], {"n_layers": 4})


def _records(root: Path, compile_key: str):
    """Synthetic dry-run records in the reference's format: a layer-probed
    cell, a loop-free one, an MWIS sweep cell and a failed one."""
    root.mkdir()

    def base(arch, shape, mesh_kind, flops, mem, coll, mf):
        roof = jrl.from_cell({"flops": flops, "bytes accessed": mem}, coll,
                             mf, 256)
        return dict(arch=arch, shape=shape, mesh=mesh_kind, n_chips=256,
                    ok=True, **{compile_key: 12.34},
                    memory=dict(argument_bytes=3.5e9, output_bytes=1e9,
                                temp_bytes=7.25e9),
                    cost=dict(flops=flops, bytes_accessed=mem),
                    collectives=coll, roofline=roof.report(), note="n")

    def probe(flops, mem, coll, layers):
        return dict(ok=True, cost=dict(flops=flops, bytes_accessed=mem),
                    collectives=coll, probe_layers=layers)

    files = {
        "qwen3-32b__train_4k__single": base(
            "qwen3-32b", "train_4k", "single", 1e12, 3e11,
            {"all-reduce": 4e9}, 5e16),
        "qwen3-32b__train_4k__single_probep2": probe(
            2e13, 4e11, {"all-gather": 1e9}, 2),
        "qwen3-32b__train_4k__single_probep4": probe(
            3.5e13, 7e11, {"all-gather": 1.5e9, "all-reduce": 1e8}, 4),
        "dlrm-mlperf__serve_p99__multi": base(
            "dlrm-mlperf", "serve_p99", "multi", 5e9, 2e10, {}, 2.5e9),
        "dlrm-mlperf__serve_p99__multi_probep1": probe(6e9, 3e10, {}, None),
        "mwis__weak_1m__single": base(
            "mwis", "weak_1m", "single", 1e8, 9e9, {"all-to-all": 2e6},
            1e9),
        "mwis__weak_1m__single_probesweep": probe(
            2e8, 1e10, {"all-to-all": 3e6}, None),
        "grok-1-314b__decode_32k__single": dict(
            arch="grok-1-314b", shape="decode_32k", mesh="single", ok=False,
            error="boom"),
    }
    for name, rec in files.items():
        (root / f"{name}.json").write_text(json.dumps(rec))
    return [n.split("__") for n in files if n.count("_probe") == 0
            and files[n].get("ok")]


def test_finalize_and_tables_match_reference(tmp_path, monkeypatch):
    """The port's ``finalize_cell``, ``roofline_table`` and ``dryrun_table``
    on the same synthetic records give the reference's numbers and text
    (its constants set to the port's; the dry-run table's time column is
    the reference's compile_s and the port's run_s)."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jrl, name, getattr(trl, name))
    cells = _records(tmp_path / "ref", "compile_s")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    for p in (tmp_path / "port").glob("*.json"):
        rec = json.loads(p.read_text())
        if "compile_s" in rec:
            rec["run_s"] = rec.pop("compile_s")
        p.write_text(json.dumps(rec))
    for arch, shape, mesh_kind in cells:
        want = jex.finalize_cell(str(tmp_path / "ref"), arch, shape,
                                 mesh_kind)
        got = tex.finalize_cell(str(tmp_path / "port"), arch, shape,
                                mesh_kind)
        want.pop("compile_s")
        got.pop("run_s")
        assert got == want, arch
    assert jex.finalize_cell(str(tmp_path / "ref"), "nope", "x", "y") is None
    assert tex.finalize_cell(str(tmp_path / "port"), "nope", "x", "y") is None
    for tag in ("", "final"):
        jr = jrep.load(str(tmp_path / "ref"), tag)
        tr = trep.load(str(tmp_path / "port"), tag)
        assert len(tr) == len(jr) > 0
        assert trep.roofline_table(tr) == jrep.roofline_table(jr)

        def drop_time(text):
            return [row.split("|")[:5] + row.split("|")[6:]
                    for row in text.splitlines()]

        assert (drop_time(trep.dryrun_table(tr))
                == drop_time(jrep.dryrun_table(jr)))
    assert trep.fmt_si(1.5e12) == jrep.fmt_si(1.5e12) == "1.50T"
    notes = trep.notes_table(trep.load(str(tmp_path / "port")))
    assert "| grok-1-314b | decode_32k | single | FAILED | boom |" in notes


def test_roofline_matches_reference_at_the_same_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jrl, name, getattr(trl, name))
    args = ({"flops": 3e15, "bytes accessed": 2e12}, {"all-gather": 5e9},
            9e17, 512)
    assert trl.from_cell(*args).report() == jrl.from_cell(*args).report()
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.LINK_BW) == (989.4e12, 3.35e12,
                                                         4.5e11)


# --------------------------------------------------------------------- #
# the per-PE sweep-round probe
# --------------------------------------------------------------------- #
REFERENCE_SWEEP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core import distributed as D, partition as part, solvers as S
    from repro.graphs import generators as gen
    from repro.launch.mesh import make_host_mesh

    mesh = make_host_mesh({p})
    g = gen.rgg2d({n}, avg_deg=7, seed=5)
    pg = part.partition_graph(g, {p}, window_cap={window_cap})
    out = {{}}
    for ex in ("allgather", "a2a"):
        cfg = D.DisReduConfig(heavy_k={heavy_k}, mode="async", exchange=ex,
                              schedule="cheap-fused", backend="blocked")
        run, keys = S.sweep_probe_shard_map_fn(pg, cfg, mesh)
        arrs = D.shard_map_arrays(pg, cfg)
        for k, v in zip(("w", "status", "offset"), jax.jit(run)(
                {{k: jnp.asarray(arrs[k]) for k in keys}})):
            out[ex + "_" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""").format(n=N, p=P, window_cap=WINDOW_CAP, heavy_k=HEAVY_K)


@pytest.mark.slow
def test_sweep_probe_matches_reference_shard_map(tmp_path):
    """The port's per-PE sweep-round probe on 4 gloo CPU ranks against the
    reference's ``sweep_probe_shard_map_fn`` on 4 host devices (a
    subprocess), rank for rank, bit for bit: w, status and offset, for the
    allgather and the a2a exchange; and each rank's count record."""
    path = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    ref = subprocess.run(
        [sys.executable, "-c", REFERENCE_SWEEP, str(path)], env=env,
        capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = np.load(path)
    g = tgen.rgg2d(N, avg_deg=7, seed=5)
    pg = tpart.partition_graph(g, P, window_cap=WINDOW_CAP)
    jobs = [mesh.PEJob("sweep", TD.DisReduConfig(
        heavy_k=HEAVY_K, mode="async", exchange=ex, schedule="cheap-fused",
        backend="cuda")) for ex in ("allgather", "a2a")]
    outs, _ = mesh.run_shard_map([pg], jobs, backend="gloo", device="cpu",
                                 directory=str(tmp_path))
    for ex, out in zip(("allgather", "a2a"), outs):
        for k in ("w", "status", "offset"):
            np.testing.assert_array_equal(out[k], want[ex + "_" + k],
                                          err_msg=f"{ex}: {k}")
        assert (out["rounds"] == 1).all()
        rec = tbase.rank_counts(out)
        assert rec["kernels"]["segment_fused"]["units"] > 0
        kind = "all-gather" if ex == "allgather" else "all-to-all"
        assert rec["collectives"][kind] > 0 and rec["bytes"] > 0


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def _cli(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_lists_the_reference_cells():
    res = _cli("--list")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [tuple(line.split()) for line in res.stdout.splitlines()]
    want = [(a, s, m) for a, s, _ in jreg.all_cells()
            for m in ("single", "multi")]
    assert [c for c in lines if c[2] != "card"] == want
    assert [c[:2] for c in lines if c[2] == "card"] == [
        c[:2] for c in want if c[2] == "single"]


def test_cli_cell_on_the_cpu_writes_the_reference_keys(tmp_path):
    """gemma3-1b × decode_32k by ``--probes`` on the CPU at widths cut by
    ``--override`` (seq 64): probes L 2, 4 at the full batch, a record for
    every mesh with the reference's record and roofline keys, the card's
    terms the single mesh's × 256; without ``--device`` it refuses to
    run."""
    ov = [x for kv in ("d_model=64", "n_heads=4", "d_head=16", "d_ff=128",
                       "vocab=128", "local_window=8", "attn_chunk=16",
                       "seq=64", "batch=4")
          for x in ("--override", kv)]
    res = _cli("--arch", "gemma3-1b", "--shape", "decode_32k", "--probes",
               "--device", "cpu", "--mesh", "card", "--out", str(tmp_path),
               *ov)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = {m: json.loads((tmp_path / f"gemma3-1b__decode_32k__{m}.json")
                          .read_text()) for m in dryrun.MESH_CHIPS}
    ref_keys = {"arch", "shape", "mesh", "n_chips", "ok", "memory", "cost",
                "collectives", "roofline", "note", "overrides"}
    roof_keys = set(jrl.Roofline(1, 1, 1, 1).report())
    for m, rec in recs.items():
        assert ref_keys <= set(rec) and rec["ok"], m
        assert set(rec["roofline"]) == roof_keys
        assert rec["full_point"] == {"n_layers": 26}
        assert [p["tag"] for p in rec["probes"]] == ["L4", "L2"]
        assert (tmp_path / f"gemma3-1b__decode_32k__{m}_probeL2.json"
                ).exists()
    assert recs["card"]["cost"]["flops"] == pytest.approx(
        256 * recs["single"]["cost"]["flops"], rel=1e-12)
    assert "extrapolated multilinearly" in recs["card"]["note"]
    assert tex.finalize_cell(str(tmp_path), "gemma3-1b", "decode_32k",
                             "card")["cost"] == recs["card"]["cost"]
    refused = _cli("--arch", "gemma3-1b", "--shape", "decode_32k",
                   "--probes", "--out", str(tmp_path / "x"))
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr


def test_probe_plans():
    """LM train: L 2, 4 × B 1, 2 first, then L 1, 2; decode keeps its batch
    first; a pinned axis is not probed; DLRM probes table rows."""
    plans, full = dryrun._probe_overrides(treg.get("qwen3-32b"), "train_4k")
    assert [[t for t, _, _ in p] for p in plans] == [
        ["L4B2", "L4B1", "L2B2", "L2B1"], ["L2B2", "L2B1", "L1B2", "L1B1"]]
    assert full == {"n_layers": 64, "batch": 256}
    plans, _ = dryrun._probe_overrides(treg.get("gemma3-1b"), "decode_32k")
    assert plans[0] == [("L4", {"n_layers": 4}, {"n_layers": 4}),
                        ("L2", {"n_layers": 2}, {"n_layers": 2})]
    assert [t for t, _, _ in plans[1]] == ["L4B2", "L4B1", "L2B2", "L2B1"]
    plans, _ = dryrun._probe_overrides(treg.get("gemma3-1b"), "train_4k",
                                       pinned=("n_layers", "batch"))
    assert plans == [[("p1", {}, {})]]
    plans, full = dryrun._probe_overrides(treg.get("dlrm-mlperf"),
                                          "train_batch")
    assert [t for t, _, _ in plans[0]] == ["R2000000", "R1000000"]
    assert full["table_rows"] > plans[0][0][2]["table_rows"]
