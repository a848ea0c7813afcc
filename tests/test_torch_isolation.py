"""The port stands alone: importing and running it — the solver, the staged
solver with its checkpoint and fault harness, the serving layer (with
descent on, pipelined, and sharded over four CPU devices), the DLRM and
LM models with the data pipeline, the optimizers, the serving CLIs (every
serving arch), the training CLI, DLRM's and the GNNs' smoke train steps,
the dry-run (its work counter, configs, registry, probes and tables),
gradient compression, the dry-run's abstract count on meta tensors (a GNN,
DLRM and a prefill cell) and the per-PE path's spawned ranks (the dry-run's
sweep-round probe and the hierarchical psum among them) —
loads neither JAX nor the reference package,
an entry point without ``device=`` refuses to run when no GPU is visible,
and CPU tensors never count as kernel launches — neither on the solver's
or the service's path nor through the kernel ops off it."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

SCRIPT = textwrap.dedent("""
    import sys
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.analysis import count, extrapolate, report, roofline
    from repro_torch.configs import base, registry
    from repro_torch.distributed import compression
    from repro_torch.launch import dryrun
    from repro_torch.core import distributed as D
    from repro_torch.core import partition as part
    from repro_torch.core import serve as SV
    from repro_torch.core import solvers as S
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import (
        FaultPlan, InjectedFault, remesh_plan, run_union_reduction,
    )
    from repro_torch.configs import dlrm_mlperf, gemma3_1b
    from repro_torch.configs import (
        dimenet_cfg, equiformer_v2_cfg, gatedgcn_cfg, graphsage_reddit,
    )
    from repro_torch.data import pipeline as dp
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.segment_coo.ops import pack_blocks, segment_sum_coo
    from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
    from repro_torch.launch import mesh, mwis_run
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.train import optimizer as opt
    from repro_torch.models import common as MC
    from repro_torch.models import dlrm as DM
    from repro_torch.models import transformer as TM

    assert not torch.cuda.is_available()
    g = gen.rgg2d(200, avg_deg=6, seed=0)
    pg = part.partition_graph(g, 2, window_cap=8)
    cfg = D.DisReduConfig(mode="async", schedule="cheap-fused",
                          backend="cuda")
    members, _ = S.solve(pg, "rnp", cfg, device="cpu")
    assert g.is_independent_set(members)
    assert kernels.launch_count("segment_fused") == 0

    ladder = (S.LadderCell("a", 16, 256, 8, 4, 4),
              S.LadderCell("b", 48, 768, 16, 8, 8))
    dcfg = D.DisReduConfig(mode="async", schedule="cheap-fused",
                           backend="cuda", descent=True)
    ck = CheckpointManager(tempfile.mkdtemp(), async_write=True)

    def kill(descents, cell):
        raise InjectedFault(cell)

    try:
        S.solve_staged(g, 2, "rnp", dcfg, ladder=ladder, pg=pg, ckpt=ck,
                       on_descent=kill, device="cpu")
    except InjectedFault:
        pass
    staged, st = S.solve_staged(g, 2, "rnp", dcfg, ladder=ladder, pg=pg,
                                ckpt=ck, resume=True, device="cpu")
    assert st["descents"] >= 1 and np.array_equal(staged, members)
    prob = D.build_union_problem(pg, "cuda", device="cpu")
    _, _, rep = run_union_reduction(prob, cfg, faults=FaultPlan(
        delay_pe=1, delay_rounds=2))
    assert rep["fixpoint"] and not rep["violations"]
    assert len(remesh_plan(200, 2, 3)["copies"]) == 3

    prob = D.build_union_problem(pg, "torch", device="cpu")
    c, k = common_neighbor_stats(prob.aux.window, prob.w0,
                                 prob.is_local | prob.is_ghost,
                                 prob.aux.row, prob.aux.col)
    assert c.shape == k.shape == prob.aux.row.shape
    row = prob.aux.row.numpy()
    perm, lrow, _ = pack_blocks(row, prob.p * prob.V, r_blk=8)
    data = torch.ones((row.shape[0], 3), dtype=torch.bfloat16)
    s = segment_sum_coo(data, torch.from_numpy(perm.astype(np.int32)),
                        torch.from_numpy(lrow), prob.p * prob.V)
    assert s.dtype == torch.bfloat16
    assert int(s.float().sum()) == 3 * row.shape[0]
    out = embedding_bag(torch.ones((5, 4)), torch.zeros((2, 3),
                                                         dtype=torch.int32),
                        torch.ones((2, 3)))
    assert out.tolist() == [[3.0] * 4] * 2
    svc = SV.MWISService(SV.ServeConfig(backend="cuda", device="cpu",
                                        verify="full", descent="auto",
                                        descent_min_L=256))
    res = svc.solve_batch([gen.gnm(n, 2 * n, seed=s)
                           for s, n in enumerate((40, 40, 200))])
    assert all(r.ok for r in res), res
    assert svc.stats["backend_active"] == "cuda"
    assert svc.stats["descent_solves"] == 1
    reqs = [gen.gnm(30 + s, 60, seed=s) for s in range(4)]
    piped = SV.MWISService(SV.ServeConfig(backend="cuda", device="cpu",
                                          max_batch=2))
    res = piped.solve_batch(reqs)
    assert piped.stats["pipelined_chunks"] == 2, piped.stats
    visible = mesh.visible_devices
    mesh.visible_devices = lambda kind: (torch.device(kind),) * 4
    sharded = SV.MWISService(SV.ServeConfig(backend="cuda", device="cpu"))
    mesh.visible_devices = visible
    for a, b in zip(sharded.solve_batch(reqs), res):
        assert a.ok and b.ok and np.array_equal(a.members, b.members)
    assert sharded.stats["devices"] == 4
    piped.close()
    sharded.close()
    serve_cli.main(["--device", "cpu", "--requests", "2", "--batch", "2",
                    "--repeat-topologies", "2", "--algo", "greedy"])
    dcfg = dlrm_mlperf.SMOKE
    dlrm = DM.DLRM(dcfg, MC.init_params(
        DM.param_specs(dcfg), torch.Generator().manual_seed(0), "cpu"))
    b = dp.dlrm_batch(dp.DLRMBatchSpec(4, 13, 26, dcfg.vocabs), 0)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        assert DM.serve_step(dlrm, tb, dcfg).shape == (4,)
        assert DM.loss_fn(dlrm, tb, dcfg).isfinite()
    lcfg = gemma3_1b.SMOKE
    lm = TM.Transformer(lcfg, MC.init_params(
        TM.param_specs(lcfg), torch.Generator().manual_seed(0), "cpu"))
    (shape, dt), _ = TM.make_kv_cache_specs(lcfg, 2, 8)
    cache = (torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt))
    tok = dp.lm_batch(dp.LMBatchSpec(2, 1, lcfg.vocab), 0)["tokens"]
    with torch.no_grad():
        logits, _ = TM.serve_step(lm, cache, torch.from_numpy(tok), 0, lcfg)
    assert logits.shape == (2, lcfg.vocab)
    for arch in serve_cli.ARCHES[1:]:
        serve_cli.main(["--arch", arch, "--device", "cpu", "--requests",
                        "2", "--batch", "2", "--tokens", "2"])
    out = train_cli.main(["--arch", "qwen3-moe-235b-a22b", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--ckpt", tempfile.mkdtemp()])
    assert np.isfinite(out["losses"][0]), out
    w = {"w": torch.zeros(3, 3)}
    st = opt.adafactor_init(w)
    w, st = opt.adafactor_update({"w": torch.ones(3, 3)}, st, w,
                                 opt.AdafactorConfig())
    assert int(st.step) == 1 and float(w["w"][0, 0]) < 0
    for smoke in (dlrm_mlperf, graphsage_reddit, gatedgcn_cfg, dimenet_cfg,
                  equiformer_v2_cfg):
        smoke.smoke(device="cpu")
    assert len(registry.all_cells()) == 39
    cell = dryrun.run_cell("gemma3-1b", "decode_32k", "cpu", overrides=dict(
        d_model=32, n_heads=2, d_head=16, d_ff=64, vocab=64, seq=32,
        batch=2), abstract=False)
    rec = dryrun.mesh_record("gemma3-1b", "decode_32k", "card", cell,
                             cell["total"], dryrun.device_info("cpu"))
    assert rec["ok"] and rec["roofline"]["bottleneck"] in (
        "compute", "memory")
    assert "FAILED" not in report.roofline_table([rec])
    for arch, shape, ov, kernel, units in (
            ("gatedgcn", "molecule", dict(d_hidden=16, n_layers=2),
             "segment_sum", 4),
            ("dlrm-mlperf", "train_batch", dict(row_cap=1000),
             "embedding_bag_backward", 26)):
        ab = dryrun.run_cell(arch, shape, overrides=ov, abstract=True)
        assert ab["counted_on"] == "meta", ab
        assert ab["total"]["kernels"][kernel]["units"] == units, ab
    ab = dryrun.run_cell("gemma3-1b", "prefill_32k", abstract=True,
                         overrides=dict(d_model=32, n_heads=2, d_head=16,
                                        d_ff=64, vocab=64, seq=32, batch=2))
    assert [p["tag"] for p in ab["probes"]] == ["L1", "L2", "L6"]
    with count.WorkCounter() as wc:
        compression.compress_int8_ef({"w": torch.ones(4)},
                                     compression.ef_init({"w": torch.ones(4)}))
    assert wc.bytes > 0 and roofline.PEAK_FLOPS == 989.4e12
    assert extrapolate.FULL_LAYERS["gemma3-1b"] == 26
    assert base.MWIS_SHAPES["weak_1m"]["L"] == 1 << 20
    counts = tuple(kernels.launch_count(k) for k in kernels.KERNELS)
    assert counts == (0,) * len(kernels.KERNELS), counts

    for call in (lambda: S.solve(pg, "rnp", cfg),
                 lambda: S.solve_staged(g, 2, "rnp", dcfg, pg=pg),
                 lambda: D.disredu(pg, cfg),
                 lambda: mwis_run.main(["--n", "50", "--p", "2"]),
                 lambda: SV.MWISService(),
                 lambda: serve_cli.main(["--requests", "2"]),
                 lambda: serve_cli.main(["--arch", "dlrm-mlperf"]),
                 lambda: serve_cli.main(["--arch", "qwen3-32b"]),
                 lambda: train_cli.main(["--steps", "1", "--ckpt",
                                         tempfile.mkdtemp()]),
                 lambda: dlrm_mlperf.smoke(),
                 lambda: graphsage_reddit.smoke(),
                 lambda: registry.get("mwis").smoke(),
                 lambda: dryrun.run_cell("gemma3-1b", "decode_32k",
                                         abstract=False)):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("ran without a GPU and without device=cpu")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "repro" or m.startswith("repro."))
    assert not leaked, leaked
    print("ISOLATED")
""")


def test_port_imports_no_jax_and_needs_an_explicit_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout


RANKS = textwrap.dedent("""
    import numpy as np

    for name in ("jax", "jaxlib", "repro"):
        try:
            __import__(name)
        except ImportError:
            pass
        else:
            raise AssertionError(f"{name} imports despite the stand-in")

    from repro_torch.core import distributed as D
    from repro_torch.core import partition as part
    from repro_torch.core import solvers as S
    from repro_torch.distributed import compression
    from repro_torch.graphs import generators as gen
    from repro_torch.launch import mesh

    g = gen.rgg2d(200, avg_deg=6, seed=0)
    pg = part.partition_graph(g, 2, window_cap=8)
    cfg = D.DisReduConfig(mode="async", exchange="a2a",
                          schedule="cheap-fused", backend="cuda")
    outs, _ = mesh.run_shard_map([pg], [mesh.PEJob("reduce", cfg),
                                     mesh.PEJob("rnp", cfg),
                                     mesh.PEJob("sweep", cfg)], device="cpu")
    assert "segment_fused" in outs[2]["count"][0]
    (ps,) = mesh.spawn_pes(compression.psum_rank, 2, args=(
        [(1, 2)], [np.ones((2, 3), np.float32)]), device="cpu")
    assert (ps["hier"] == 2).all()
    members, _ = S.solve(pg, "rnp", cfg, device="cpu")
    assert np.array_equal(D.members_global_per_pe(pg, outs[1]["members"]),
                          members)
    print("RANKS ISOLATED")
""")


def test_spawned_ranks_import_no_jax(tmp_path):
    """The per-PE path's ranks (spawned interpreters, which import their
    entry's module afresh) run with stand-ins for ``jax``, ``jaxlib`` and
    ``repro`` first on the path that raise when imported, so a rank that
    loaded any of them would fail the run."""
    for name in ("jax", "jaxlib", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('the port must not import {name}')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{SRC}",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", RANKS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RANKS ISOLATED" in res.stdout


def test_port_sources_never_import_the_reference():
    """No module of the port names jax or the reference package in an
    import statement (the subprocess test covers what actually loads)."""
    bad = []
    for path in (SRC / "repro_torch").rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")) and (
                    s.split()[1].split(".")[0] in ("jax", "jaxlib", "repro")):
                bad.append(f"{path.name}:{i}: {s}")
    assert not bad, bad
