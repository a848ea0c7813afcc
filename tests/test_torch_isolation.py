"""The port stands alone: importing and running it — the solver, the staged
solver with its checkpoint and fault harness, the serving layer (with
descent on), both CLIs and the per-PE path's spawned ranks — loads neither
JAX nor the reference package,
an entry point without ``device=`` refuses to run when no GPU is visible,
and CPU tensors never count as kernel launches — neither on the solver's
or the service's path nor through the three kernel ops off it."""

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
    from repro_torch.core import distributed as D
    from repro_torch.core import partition as part
    from repro_torch.core import serve as SV
    from repro_torch.core import solvers as S
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import (
        FaultPlan, InjectedFault, remesh_plan, run_union_reduction,
    )
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.segment_coo.ops import pack_blocks, segment_sum_coo
    from repro_torch.kernels.wedge_intersect.ops import common_neighbor_stats
    from repro_torch.launch import mwis_run
    from repro_torch.launch import serve as serve_cli

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
    serve_cli.main(["--device", "cpu", "--requests", "2", "--batch", "2",
                    "--repeat-topologies", "2", "--algo", "greedy"])
    counts = tuple(kernels.launch_count(k) for k in (
        "segment_fused", "segment_sum", "wedge_intersect", "embedding_bag"))
    assert counts == (0, 0, 0, 0), counts

    for call in (lambda: S.solve(pg, "rnp", cfg),
                 lambda: S.solve_staged(g, 2, "rnp", dcfg, pg=pg),
                 lambda: D.disredu(pg, cfg),
                 lambda: mwis_run.main(["--n", "50", "--p", "2"]),
                 lambda: SV.MWISService(),
                 lambda: serve_cli.main(["--requests", "2"])):
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
    from repro_torch.graphs import generators as gen
    from repro_torch.launch import mesh

    g = gen.rgg2d(200, avg_deg=6, seed=0)
    pg = part.partition_graph(g, 2, window_cap=8)
    cfg = D.DisReduConfig(mode="async", exchange="a2a",
                          schedule="cheap-fused", backend="cuda")
    outs, _ = mesh.run_shard_map([pg], [mesh.PEJob("reduce", cfg),
                                     mesh.PEJob("rnp", cfg)], device="cpu")
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
