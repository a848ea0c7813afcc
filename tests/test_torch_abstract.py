"""The dry-run's abstract half: cells counted on meta tensors.

``models.common.abstract_params``, ``configs.base.opt_abstract`` and
``configs.base.sds`` against the reference's abstract inputs (shapes and
dtypes, full size, every cell but MWIS's and ``ogb_products``' edge
draws); the count of a step on meta against its count on the CPU from the
same inputs, field by field, for every family; the GNN plans packed from a
batch's host copies; the kernel ops on meta (one unit of their formula, no
launch; a mix of devices raises; a formula without its host figure
raises); the storage tally; the layer-kind combination of prefill probes;
the ``--abstract`` CLI.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro_torch import kernels
from repro_torch.analysis import count
from repro_torch.analysis import extrapolate as tex
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.segment_coo.ops import pack_blocks, segment_sum_coo
from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
from repro_torch.launch import dryrun
from repro_torch.models import common as MC
from repro_torch.models.gnn import common as G
from repro_torch.train import optimizer as opt

from _torch_jax import _release_jax_programs  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _shapes(tree, path=""):
    """{path: (shape, dtype name)} of a tree's tensors or
    ShapeDtypeStructs (named tuples by field; a batch's host copies and
    plain numbers left out)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) if key != "host"
                for k, v in _shapes(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _shapes(x, f"{path}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        assert tree.is_meta, path
        return {path: (tuple(tree.shape),
                       str(tree.dtype).removeprefix("torch."))}
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return {path: (tuple(tree.shape), str(tree.dtype))}
    return {}


ABSTRACT_CELLS = [(a, s) for a, s, _ in jreg.all_cells()
                  if a != "mwis" and s != "ogb_products"]


@pytest.mark.parametrize("arch_id,shape", ABSTRACT_CELLS)
def test_abstract_inputs_match_reference(host_mesh, arch_id, shape):
    """A cell's meta inputs — weights from ``abstract_params``, optimizer
    state from ``opt_abstract``, the rest from ``sds`` — have the shapes
    and dtypes of the reference's abstract inputs at full size (decode's
    cache length is an int in the port)."""
    want = jreg.get(arch_id).build(shape, host_mesh, ("data",))
    got = treg.get(arch_id).build(shape).make_inputs("meta", 0)
    ref_inputs = want.abstract_inputs
    if tbase.LM_SHAPES.get(shape, {}).get("kind") == "decode":
        assert got[4] == tbase.LM_SHAPES[shape]["seq"] - 1
        got, ref_inputs = got[:4], ref_inputs[:4]
    assert _shapes(got) == _shapes(ref_inputs)


@pytest.mark.parametrize("arch_id", [a for a in treg.ARCHS if a != "mwis"])
def test_abstract_params_and_opt_abstract(arch_id):
    """``abstract_params`` is ``init_params``' tree on meta, and
    ``opt_abstract`` is ``adamw_init``'s state on meta, at a tiny config
    of each arch's family (materialised on the CPU to compare)."""
    arch = treg.get(arch_id)
    specs = _tiny_specs(arch)
    params = MC.init_params(specs, torch.Generator().manual_seed(0), "cpu")
    abstract = MC.abstract_params(specs)
    assert _shapes(_to_meta(params)) == _shapes(abstract)
    state = tbase.opt_abstract(abstract)
    assert isinstance(state, opt.AdamWState)
    assert _shapes(state) == _shapes(_to_meta(opt.adamw_init(params)))


def _to_meta(tree):
    if isinstance(tree, torch.Tensor):
        return tree.to("meta")
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_meta(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return tree


def _module_of(arch_id):
    return importlib.import_module("repro_torch.configs." + {
        "qwen3-moe-235b-a22b": "qwen3_moe_235b", "grok-1-314b": "grok1_314b",
        "mistral-nemo-12b": "mistral_nemo_12b", "qwen3-32b": "qwen3_32b",
        "gemma3-1b": "gemma3_1b", "equiformer-v2": "equiformer_v2_cfg",
        "dimenet": "dimenet_cfg", "gatedgcn": "gatedgcn_cfg",
        "graphsage-reddit": "graphsage_reddit",
        "dlrm-mlperf": "dlrm_mlperf"}[arch_id])


def _tiny_specs(arch):
    smoke = _module_of(arch.arch_id).SMOKE
    if arch.family == "lm":
        from repro_torch.models import transformer as T
        return T.param_specs(smoke)
    if arch.family == "recsys":
        from repro_torch.models import dlrm as M
        return M.param_specs(smoke)
    return _module_of(arch.arch_id).module.param_specs(smoke)


def _smoke_overrides(arch_id):
    smoke = _module_of(arch_id).SMOKE
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if f.name != "name"}


#: (arch, shape, extra overrides) of the meta-against-CPU cases: every
#: family's step at its SMOKE widths (the LMs' seq and batch cut).
FAMILY_CASES = [
    ("qwen3-32b", "train_4k", dict(seq=32, batch=2)),
    ("qwen3-moe-235b-a22b", "train_4k", dict(seq=32, batch=2)),
    ("gemma3-1b", "prefill_32k", dict(seq=64, batch=2)),
    ("qwen3-moe-235b-a22b", "prefill_32k", dict(seq=32, batch=2)),
    ("gemma3-1b", "decode_32k", dict(seq=64, batch=2)),
    ("grok-1-314b", "decode_32k", dict(seq=32, batch=3)),
    ("graphsage-reddit", "full_graph_sm", {}),
    ("gatedgcn", "molecule", {}),
    ("dimenet", "molecule", {}),
    ("equiformer-v2", "molecule", {}),
    ("dlrm-mlperf", "train_batch", {}),
    ("dlrm-mlperf", "serve_p99", {}),
    ("dlrm-mlperf", "retrieval_cand", {}),
]


def _plan_bytes(plans):
    """Bytes of the plans' tensors: what the host uploads a forward."""
    flat = [p for v in plans.values()
            for p in (v if isinstance(v, list) else [v])]
    return sum(t.numel() * t.element_size() for p in flat
               for t in (p.edge_perm, p.lrow, p.gather))


@pytest.mark.parametrize("arch_id,shape,cut", FAMILY_CASES)
def test_meta_count_equals_cpu_count(arch_id, shape, cut):
    """A step counted on meta equals its count on the CPU from the same
    host-drawn index arrays, field by field: FLOPs (and by class),
    transcendentals, bytes, collectives and every kernel's units,
    operations and bytes.  Transfer
    bytes: the CPU moves nothing; meta, like the card, uploads the GNN
    plans packed on the host, and nothing else."""
    arch = treg.get(arch_id)
    built = arch.build(shape, {**_smoke_overrides(arch_id), **cut})
    cpu_inputs = built.make_inputs("cpu", 0)
    _, cpu = count.measure(built.fn, cpu_inputs, "cpu")
    _, meta = count.measure(built.fn, built.make_inputs("meta", 0), "meta")
    for k in ("flops", "transcendentals", "flops_by_class", "bytes",
              "collectives", "kernels"):
        assert meta[k] == cpu[k], (k, {
            op: (meta["by_op"].get(op), cpu["by_op"].get(op))
            for op in set(meta["by_op"]) | set(cpu["by_op"])
            if meta["by_op"].get(op) != cpu["by_op"].get(op)})
    assert cpu["transfer_bytes"] == 0
    uploads = 0
    if arch.family == "gnn":
        module = _module_of(arch_id).module
        uploads = _plan_bytes(module.plans(cpu_inputs[2], built.cfg))
        assert uploads > 0
    assert meta["transfer_bytes"] == uploads
    assert meta["flops"] > 0 and meta["memory"]["temp_bytes"] > 0
    assert "host_s" in meta and "run_s" not in meta
    # on the CPU a host copy is the batch's own tensor
    assert meta["memory"]["argument_bytes"] == cpu["memory"][
        "argument_bytes"]


@pytest.mark.parametrize("arch_id", ["gatedgcn", "dimenet",
                                     "equiformer-v2"])
def test_plans_from_host_copies(arch_id):
    """A model's plans packed from a batch's host copies equal, bit for
    bit, the plans packed from its tensors; on meta they have the same
    shapes, and ``n_live`` is each plan's live slots."""
    built = treg.get(arch_id).build("molecule", _smoke_overrides(arch_id))
    module, cfg = _module_of(arch_id).module, built.cfg
    _, _, batch = built.make_inputs("cpu", 3)
    plain = {k: v for k, v in batch.items() if k != "host"}
    _, _, meta_batch = built.make_inputs("meta", 3)

    def flat(plans):
        return [p for v in plans.values()
                for p in (v if isinstance(v, list) else [v])]

    want = flat(module.plans(plain, cfg))
    got = flat(module.plans(batch, cfg))
    on_meta = flat(module.plans(meta_batch, cfg))
    assert len(want) == len(got) == len(on_meta) >= 1
    for w, g, m in zip(want, got, on_meta):
        for f in ("edge_perm", "lrow", "gather"):
            assert torch.equal(getattr(w, f), getattr(g, f))
            assert getattr(m, f).is_meta
            assert getattr(m, f).shape == getattr(w, f).shape
        assert (w.n, w.n_entries, w.n_live) == (m.n, m.n_entries, m.n_live)
        assert w.n_live == int((w.lrow < w.r_blk).sum())


def test_scatter_plan_from_a_host_array():
    """``scatter_plan`` of a host array sent to a device equals the plan
    of the same array on that device, bit for bit; ``n_live`` counts the
    live entries (segment < n and the mask)."""
    rng = np.random.default_rng(1)
    n = 40
    seg = np.concatenate([rng.integers(0, n, 300), np.full(50, n)]
                         ).astype(np.int32)
    live = rng.random(seg.shape[0]) < 0.6
    host = G.scatter_plan(torch.from_numpy(seg), n, torch.from_numpy(live),
                          device=torch.device("cpu"))
    own = G.scatter_plan(torch.from_numpy(seg.copy()), n,
                         torch.from_numpy(live.copy()))
    for f in ("edge_perm", "lrow", "gather"):
        assert torch.equal(getattr(host, f), getattr(own, f))
    assert host.n_live == own.n_live == int(((seg < n) & live).sum())
    meta = G.scatter_plan(torch.from_numpy(seg), n, torch.from_numpy(live),
                          device=torch.device("meta"))
    assert meta.edge_perm.is_meta and meta.lrow.shape == own.lrow.shape
    dead = G.scatter_plan(torch.full((7,), n, dtype=torch.int32), n)
    assert dead.n_live == 0


def _kernel_inputs():
    rng = np.random.default_rng(0)
    row = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    perm, lrow, _ = pack_blocks(row, 40, r_blk=8)
    return (torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32)),
            torch.from_numpy(perm.astype(np.int32)), torch.from_numpy(lrow))


def test_kernel_ops_on_meta_count_one_unit_of_their_formula():
    """On meta tensors an op returns its output's shape, launches nothing,
    and counts one unit of its formula — the same unit as on the CPU,
    given the host figure (the plan's live slots, the ids' host copy)."""
    data, perm, lrow = _kernel_inputs()
    meta = [t.to("meta") for t in (data, perm, lrow)]
    n_live = int((lrow < 8).sum())
    with count.WorkCounter() as cpu:
        want = segment_sum_coo(data, perm, lrow, 40)
    with count.WorkCounter() as wc:
        got = segment_sum_coo(*meta, 40, n_live=n_live)
    assert got.is_meta and got.shape == want.shape
    assert wc.summary() == cpu.summary()

    table = torch.randn(50, 16)
    idx = torch.from_numpy(np.random.default_rng(2).integers(
        -60, 60, (20, 3)).astype(np.int32))
    wgt, grad = torch.rand(20, 3), torch.randn(20, 16)
    counts = []
    for dev, host in (("cpu", None), ("meta", idx)):
        t, i, w, dg = (x.to(dev) for x in (table, idx, wgt, grad))
        t.requires_grad_()
        with count.WorkCounter() as wc:
            out = embedding_bag(t, i, w, host)
            (g,) = torch.autograd.grad(out, t, dg)
        assert g.shape == table.shape and g.device.type == dev
        counts.append(wc.summary())
    assert counts[0] == counts[1]
    assert counts[0]["kernels"]["embedding_bag_backward"]["units"] == 1
    assert all(kernels.launch_count(k) == 0 for k in kernels.KERNELS)


def test_kernel_op_on_mixed_devices_raises():
    data, perm, lrow = _kernel_inputs()
    with pytest.raises(ValueError, match="meta"):
        segment_sum_coo(data.to("meta"), perm, lrow, 40)
    with pytest.raises(ValueError, match="meta"):
        embedding_bag(torch.ones(5, 4, device="meta"),
                      torch.zeros(2, 1, dtype=torch.int32),
                      torch.ones(2, 1))
    window = torch.zeros(6, 4, dtype=torch.int32)
    edges = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="meta"):
        common_neighbor_stats(window.to("meta"), edges[:1].expand(6),
                              torch.ones(6, dtype=torch.bool), edges, edges)


def test_formula_on_meta_without_its_host_figure_raises():
    """A formula that reads data raises on meta tensors unless the caller
    gives the figure the host knows; it never guesses."""
    data, perm, lrow = [t.to("meta") for t in _kernel_inputs()]
    with count.WorkCounter(), pytest.raises(ValueError, match="n_live"):
        segment_sum_coo(data, perm, lrow, 40)
    # outside a counter no formula runs: the op gives its shape
    assert segment_sum_coo(data, perm, lrow, 40).shape == (40, 5)
    table = torch.ones(5, 4, device="meta", requires_grad=True)
    idx = torch.zeros(2, 1, dtype=torch.int32, device="meta")
    out = embedding_bag(table, idx, torch.ones(2, 1, device="meta"))
    with count.WorkCounter(), pytest.raises(ValueError, match="host_idx"):
        torch.autograd.grad(out, table, torch.ones(2, 4, device="meta"))
    w = torch.zeros(6, 4, dtype=torch.int32, device="meta")
    e = torch.zeros(3, dtype=torch.int32, device="meta")
    with count.WorkCounter(), pytest.raises(ValueError, match="windows"):
        common_neighbor_stats(w, torch.zeros(6, dtype=torch.int32,
                                             device="meta"),
                              torch.ones(6, dtype=torch.bool, device="meta"),
                              e, e)


def test_storage_tally_peak_of_live_storages():
    """The tally counts each storage a run creates once (views share
    it), drops it when freed, and never counts the arguments."""
    x = torch.empty(1000, device="meta")

    def step(x):
        a = x * 2.0              # 4,000 bytes
        b = a[10:]               # a view: nothing new
        c = b.exp()              # 3,960 bytes; a and c alive
        del a, b
        return c.sum()           # 4 bytes

    _, rec = count.measure(step, (x,), "meta")
    assert rec["memory"] == dict(argument_bytes=4000, output_bytes=4,
                                 temp_bytes=4000 + 3960)
    tally = count.StorageTally("meta", [x])
    with count.WorkCounter(tally):
        y = x + 1.0
        del y
        z = torch.empty(10, device="meta") + 1.0
    tally.close()
    assert tally.peak == 4000 and tally.live == 40 and z.numel() == 10


def test_affine_combines_layer_kinds_exactly():
    """Probes L 1, 2, 6 of a 5:1 interleave carry to 22 local and 4
    global layers with integer weights (-8, 5, 4); two probes of one axis
    are the reference's linear form."""
    t = {1: 100 + 7, 2: 100 + 14, 6: 100 + 35 + 11}   # fixed 100, 7, 11
    pts = [({"local_layers": a, "global_layers": b}, t[n])
           for n, a, b in ((1, 1, 0), (2, 2, 0), (6, 5, 1))]
    got = tex.affine(pts, {"local_layers": 22, "global_layers": 4})
    assert got == 100 + 22 * 7 + 4 * 11 and isinstance(got, int)
    assert tex.affine([({"n_layers": 2}, 10.0), ({"n_layers": 4}, 30.0)],
                      {"n_layers": 40}) == tex.multilinear(
        [({"n_layers": 2}, 10.0), ({"n_layers": 4}, 30.0)], {"n_layers": 40})
    with pytest.raises(ValueError):
        tex.affine([({"x": 1, "y": 2}, 1), ({"x": 2, "y": 4}, 2),
                    ({"x": 3, "y": 6}, 3)], {"x": 4, "y": 8})


@pytest.mark.parametrize("arch_id,cut", [
    ("gemma3-1b", dict(seq=64, batch=2)),
    ("qwen3-32b", dict(seq=32, batch=2)),
])
def test_abstract_prefill_equals_a_full_depth_count(arch_id, cut):
    """A prefill cell's abstract count (probes L 2, 4, or gemma3's L 1, 2,
    max(global_every, 3) by layer kind) equals the count of the full-depth step on the CPU,
    every term, at SMOKE widths."""
    ov = {**_smoke_overrides(arch_id), **cut}
    ov.pop("n_layers", None)
    full = tex.FULL_LAYERS[arch_id]
    cell = dryrun.run_cell(arch_id, "prefill_32k", overrides=ov,
                           abstract=True)
    assert cell["counted_on"] == "meta"
    built = treg.get(arch_id).build("prefill_32k", dict(ov, n_layers=full))
    _, rec = count.measure(built.fn, built.make_inputs("cpu", 0), "cpu")
    for k in ("flops", "transcendentals", "flops_by_class", "bytes",
              "transfer_bytes", "collectives", "kernels"):
        assert cell["total"][k] == rec[k], k
    tags = [p["tag"] for p in cell["probes"]]
    # gemma3's SMOKE interleave is 2:1 (global_every 3)
    assert tags == (["L1", "L2", "L3"] if arch_id == "gemma3-1b"
                    else ["L2", "L4"])


def test_retrieval_counts_its_matrix_vector_product():
    """``dlrm-mlperf × retrieval_cand`` at full size on meta: the score
    ``cand @ d[0]`` is an ``mv`` of 2 · 1 M · 128 FLOPs, so the count is
    at least the model's 2.56e8."""
    built = treg.get("dlrm-mlperf").build("retrieval_cand")
    _, rec = count.measure(built.fn, built.make_inputs("meta", 0), "meta")
    assert built.model_flops == 2.56e8
    mv = rec["by_op"]["aten.mv.default"]
    assert mv[1] == 2 * 1_000_000 * 128
    assert rec["flops"] >= built.model_flops


@pytest.mark.parametrize("arch_id,shape", [("dlrm-mlperf", "train_batch"),
                                           ("dlrm-mlperf", "serve_p99"),
                                           ("gatedgcn", "molecule")])
def test_index_arrays_are_drawn_on_the_host_on_every_device(arch_id, shape):
    """The index arrays whose data sets work come from the seed on the
    host whatever the device: a CPU batch and a meta batch carry equal
    host copies, and the CPU batch's own tensors are those copies."""
    built = treg.get(arch_id).build(shape, _smoke_overrides(arch_id))
    cpu_batch = built.make_inputs("cpu", 5)[-1]
    meta_batch = built.make_inputs("meta", 5)[-1]
    assert cpu_batch["host"].keys() == meta_batch["host"].keys()
    for k, v in cpu_batch["host"].items():
        assert v.device.type == "cpu" and meta_batch[k].is_meta
        assert torch.equal(v, meta_batch["host"][k])
        assert torch.equal(cpu_batch[k], v)


def test_card_route_records_say_they_are_superseded():
    """A cell counted by probes on a device (here the CPU, one probe at a
    pinned layer count and batch) is marked as superseded by the abstract
    count, in the cell, its note and its mesh record; the abstract count
    is not."""
    ov = {**_smoke_overrides("gemma3-1b"), "n_layers": 2, "seq": 64,
          "batch": 2}
    cell = dryrun.run_cell("gemma3-1b", "decode_32k", "cpu", ov,
                           abstract=False)
    assert cell["counted_on"] == "cpu"
    assert cell["superseded_by"] == "abstract"
    assert cell["note"].startswith(dryrun.SUPERSEDED)
    rec = dryrun.mesh_record("gemma3-1b", "decode_32k", "card", cell,
                             cell["total"], dryrun.device_info("cpu"))
    assert rec["superseded_by"] == "abstract"
    meta = dryrun.run_cell("gemma3-1b", "decode_32k", overrides=ov,
                           abstract=True)
    assert "superseded_by" not in meta
    assert meta["total"]["flops"] == cell["total"]["flops"]


def _cli(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_abstract_writes_the_reference_keys_and_counted_on(tmp_path):
    """``--abstract`` counts a GNN cell on meta without a card (and
    without ``--device``): a record a mesh with the reference's keys,
    ``counted_on`` meta, ``host_s`` for the time, one ``full`` probe."""
    ov = [x for kv in ("d_hidden=16", "n_layers=2")
          for x in ("--override", kv)]
    res = _cli("--arch", "gatedgcn", "--shape", "molecule", "--abstract",
               "--mesh", "card", "--out", str(tmp_path), *ov)
    assert res.returncode == 0, res.stderr[-3000:]
    ref_keys = {"arch", "shape", "mesh", "n_chips", "ok", "memory", "cost",
                "collectives", "roofline", "note", "overrides"}
    for m in dryrun.MESH_CHIPS:
        rec = json.loads((tmp_path / f"gatedgcn__molecule__{m}.json")
                         .read_text())
        assert ref_keys <= set(rec) and rec["ok"], m
        assert rec["counted_on"] == "meta" and "run_s" not in rec
        assert rec["host_s"] > 0 and rec["device"] == {"platform": "meta"}
        assert [p["tag"] for p in rec["probes"]] == ["full"]
        assert rec["kernels"]["segment_sum"]["units"] == 2 * 2
        assert rec["memory"]["temp_bytes"] > 0
        if m == "card":
            assert ("counted on meta in one run at the full shape"
                    in rec["note"])
        else:   # the production meshes: rank 0 of a sharded program
            assert rec["sharded"] and rec["collectives"]
            assert "counted in one run at the full shape" in rec["note"]
    probe = json.loads((tmp_path / "gatedgcn__molecule__card_probefull.json")
                       .read_text())
    assert probe["ops_without_flops"] and probe["top_ops"]
    assert "host_s" in probe


def test_cli_default_counts_an_lm_cell_on_meta(tmp_path):
    """With no route flag (and no ``--device``, no card) the dry-run counts
    an LM cell on meta: gemma3-1b × decode_32k at SMOKE widths gives
    records ``counted_on`` meta, not superseded, with the transcendentals
    beside the FLOPs; ``--abstract`` is the same route, and it excludes
    ``--probes``."""
    ov = [x for kv in ("d_model=64", "n_heads=4", "d_head=16", "d_ff=128",
                       "vocab=128", "local_window=8", "attn_chunk=16",
                       "seq=64", "batch=2", "n_layers=2")
          for x in ("--override", kv)]
    recs = {}
    for route in ((), ("--abstract",)):
        out = tmp_path / (route[0][2:] if route else "default")
        res = _cli("--arch", "gemma3-1b", "--shape", "decode_32k", *route,
                   "--mesh", "card", "--out", str(out), *ov)
        assert res.returncode == 0, res.stderr[-3000:]
        recs[route] = rec = json.loads(
            (out / "gemma3-1b__decode_32k__card.json").read_text())
        assert rec["ok"] and rec["counted_on"] == "meta"
        assert "superseded_by" not in rec and "host_s" in rec
        assert rec["transcendentals"] > 0
        assert [p["tag"] for p in rec["probes"]] == ["full"]
    assert recs[()]["cost"] == recs[("--abstract",)]["cost"]
    both = _cli("--arch", "gemma3-1b", "--shape", "decode_32k",
                "--abstract", "--probes", "--out", str(tmp_path / "x"))
    assert both.returncode == 2 and "not allowed with" in both.stderr
