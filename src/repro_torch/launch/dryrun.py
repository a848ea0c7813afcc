"""Dry-run: count every (arch × shape) cell's step and score it against the
H100 roofline.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step for a TPU pod of 256 (``single``) or 512 (``multi``)
placeholder devices and reads XLA's cost and memory analyses.  The port has
no compiler and no GSPMD: it RUNS each cell's step once on one card, at
full width, under ``analysis.count.WorkCounter``, at two probe points of up
to two reduced axes — the layers (the reference's L = 2, 4 where they fit,
else 1, 2), the batch (LM train and prefill: 1, 2; decode keeps its batch
where it fits) and DLRM's table rows (every table capped at 1 M and 2 M
rows) — and extrapolates multilinearly to the full cell
(``analysis.extrapolate``).  A probe plan that runs out of the card's
memory gives way to the next, smaller one; a cell that fits at none gets
a record with ``ok: false`` and the reason.  MWIS cells count one
sweep-round of the per-PE path (``solvers.sweep_probe_shard_map_fn``) on
``--pes`` gloo ranks over an instance at the cell's per-PE shape.

Per cell and mesh (``single`` 256 chips, ``multi`` 512, ``card`` 1) the
record holds the counted FLOPs and bytes and the collective bytes split
evenly over the chips (not a sharded program), the per-device memory,
the three roofline terms and bottleneck (``analysis.roofline``, H100
SXM5), the model FLOPs (the reference's formulas), ``run_s`` (the counted
runs' time) and the card's name and power limit.  One counted run of an
(arch, shape) serves all three meshes.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
      --mesh card
  python -m repro_torch.launch.dryrun --all            # a subprocess a cell
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k \\
      --device cpu --override d_model=64 ...     # CPU, shrunk by overrides

The reference's ``XLA_FLAGS`` preamble (512 host devices) has no
counterpart.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ARTIFACTS = str(Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")

#: Chips of each mesh: the reference's production meshes and one card.
MESH_CHIPS = {"single": 256, "multi": 512, "card": 1}

#: aten ops a probe record lists ([calls, flops, bytes]), most bytes first.
TOP_OPS = 12
#: Row caps of the DLRM probes (2 M rows a table train at B 65,536 on one
#: card).
ROW_CAPS = (1_000_000, 2_000_000)
_ABBREV = {"n_layers": "L", "n_blocks": "L", "batch": "B",
           "table_rows": "R"}

Probe = Tuple[str, Dict[str, Any], Dict[str, int]]   # tag, overrides, point


def _grid(axes: Dict[str, Optional[Tuple[int, int]]],
          fixed: Optional[Dict[str, Any]] = None) -> List[Probe]:
    """2^k probes over the ``axes`` {axis: (lo, hi) or None (not
    reduced)}, largest first; a probe's overrides set its axes' values
    (and ``fixed``).  No reduced axis: the one probe ``p1``."""
    probes = [{}]
    for axis, values in axes.items():
        if values is not None:
            probes = [dict(pt, **{axis: v}) for pt in probes for v in values]
    probes.sort(key=lambda pt: [-v for v in pt.values()])
    return [("".join(f"{_ABBREV[a]}{v}" for a, v in pt.items()) or "p1",
             dict(fixed or {}, **pt), pt) for pt in probes]


def _table_rows(cfg, cap: Optional[int] = None) -> int:
    from repro_torch.models import dlrm as M

    if cap is not None:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, vocabs=tuple(min(v, cap) for v in cfg.vocabs))
    return sum(s.shape[0] for s in M.param_specs(cfg)["tables"].values())


def _probe_overrides(arch, shape: str, pinned=()
                     ) -> Tuple[List[List[Probe]], Dict[str, int]]:
    """Per-family probe plans, tried in order until one fits the card:
    (plans, full point).  A plan is a list of (tag, overrides, point).
    An axis in ``pinned`` (a config the caller overrides) is not
    reduced."""
    from repro_torch.analysis.extrapolate import FULL_LAYERS
    from repro_torch.configs import base

    def opts(axis, *values):
        return [None] if axis in pinned else list(values)

    fam = arch.family
    if fam == "lm":
        meta = base.LM_SHAPES[shape]
        if meta["batch"] <= 2:
            batch = [None]
        elif meta["kind"] == "decode":     # the batch kept where it fits
            batch = opts("batch", None, (1, 2))
        else:
            batch = opts("batch", (1, 2))
        plans = [_grid({"n_layers": d, "batch": b})
                 for d in opts("n_layers", (2, 4), (1, 2)) for b in batch]
        full = {"n_layers": FULL_LAYERS[arch.arch_id],
                "batch": meta["batch"]}
    elif fam == "gnn":
        field = "n_blocks" if arch.arch_id == "dimenet" else "n_layers"
        depths = ([None] if arch.arch_id == "graphsage-reddit"  # exact
                  else opts(field, (2, 4), (1, 2)))
        plans = [_grid({field: d}) for d in depths]
        full = {field: FULL_LAYERS.get(arch.arch_id, 0)}
    elif fam == "recsys":
        from repro_torch.configs.dlrm_mlperf import CONFIG

        plans = [[(f"R{c}", {"row_cap": c},
                   {"table_rows": _table_rows(CONFIG, c)})
                  for c in reversed(ROW_CAPS)]]
        if "row_cap" in pinned:
            plans = [_grid({})]
        full = {"table_rows": _table_rows(CONFIG)}
    else:    # mwis: loop-free single sweep-round probe
        plans, full = [[("sweep", {"probe": True}, {})]], {}
    return list({tuple(t for t, _, _ in p): p for p in plans}.values()), full


def _full_of(points: List[Dict[str, int]], full: Dict[str, int]
             ) -> Dict[str, int]:
    """The full point over the axes the probes vary."""
    return {a: v for a, v in full.items()
            if len({pt.get(a) for pt in points}) > 1}


def _terms(rec: Dict[str, Any], kernels: Dict[str, str],
           kinds: List[str]) -> Dict[str, Any]:
    """A probe's counted terms as one tree (every kernel and collective
    kind of the cell present, 0 where this probe has none)."""
    ks = rec.get("kernels", {})
    return dict(
        flops=rec["flops"], bytes=rec["bytes"],
        transfer_bytes=rec["transfer_bytes"],
        collectives={k: rec["collectives"].get(k, 0) for k in kinds},
        kernels={k: dict(units=ks.get(k, {}).get("units", 0),
                         ops=ks.get(k, {}).get("ops", 0),
                         bytes=ks.get(k, {}).get("bytes", 0), op_class=c)
                 for k, c in kernels.items()},
        memory=dict(rec["memory"]),
    )


def _run_probe(arch, shape: str, tag: str, ov: Dict[str, Any],
               point: Dict[str, int], device, seed: int) -> Dict[str, Any]:
    """One counted run of the cell's step at one probe point."""
    from repro_torch.analysis import count

    built = arch.build(shape, ov)
    if built.measure is not None:
        _, rec = built.measure(device, seed)
    else:
        inputs = built.make_inputs(device, seed)
        _, rec = count.measure(built.fn, inputs, device)
        del inputs
    by_op = rec.pop("by_op", {})
    rec["top_ops"] = dict(sorted(by_op.items(), key=lambda kv: -kv[1][2])[
        :TOP_OPS])
    return dict(tag=tag, point=point, overrides=ov, **rec)


def _free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


#: Archs whose FFN routes tokens to experts at a capacity.
_MOE = ("qwen3-moe-235b-a22b", "grok-1-314b")


def _caveats(arch, shape: str, point: Dict[str, int]) -> List[str]:
    """Terms the probes cannot extrapolate exactly, and why."""
    from repro_torch.configs import base

    out = []
    if arch.arch_id in _MOE and "batch" in point:
        out.append("MoE capacity = round(tokens*k/E*1.25) is not affine in "
                   "the batch: the dispatch buffers' terms are approximate")
    layers = {"n_layers", "n_blocks"} & set(point)
    if layers and (arch.family == "gnn"
                   or base.LM_SHAPES[shape]["kind"] == "train"):
        out.append("each layer's weight gradient is a select_backward of "
                   "the stacked [L, ...] parameter, materialised whole and "
                   "summed (bytes O(L^2)): the bytes extrapolated linearly "
                   "in L are a lower bound")
    if arch.arch_id == "gemma3-1b" and "n_layers" in point:
        out.append("the probes' layers are all local (every 6th of 26 is "
                   "global): the full depth is counted as local layers")
    if ("table_rows" in point
            and base.RECSYS_SHAPES[shape]["kind"] == "train"):
        out.append("ids are drawn below each capped vocabulary, so the "
                   "backward kernel's touched rows are the capped tables'")
    return out


def run_cell(arch_id: str, shape: str, device="cuda",
             overrides: Optional[Dict[str, Any]] = None, seed: int = 0
             ) -> Dict[str, Any]:
    """Count ``arch_id × shape`` at its probe points on ``device`` and
    extrapolate: {probes (their counts), total (the full cell's counted
    terms), model_flops, note, full_point, family}."""
    from repro_torch import resolve_device
    from repro_torch.analysis import extrapolate as ex
    from repro_torch.configs import registry

    import torch

    dev = resolve_device(device)
    arch = registry.get(arch_id)
    if shape not in arch.shapes:
        why = arch.skips.get(shape, "not a shape of this arch")
        raise ValueError(f"{arch_id} × {shape}: {why}")
    cli = dict(overrides or {})
    full_build = arch.build(shape, cli or None)
    plans, full_point = _probe_overrides(arch, shape, pinned=tuple(cli))
    abandoned = []
    for plan in plans:
        try:
            probes = [_run_probe(arch, shape, tag, dict(ov, **cli), pt, dev,
                                 seed) for tag, ov, pt in plan]
            break
        except torch.OutOfMemoryError as e:
            why = str(e).splitlines()[0].split(". GPU ")[0]
            abandoned.append(f"probes {','.join(t for t, _, _ in plan)} "
                             f"ran out of memory ({why})")
        _free(dev)
    else:
        raise RuntimeError(f"{arch_id} × {shape} does not fit one card at "
                           f"any probe point: " + " | ".join(abandoned))
    plan_full = _full_of([p["point"] for p in probes], full_point)
    kernels = {k: v["op_class"] for p in probes
               for k, v in p.get("kernels", {}).items()}
    kinds = sorted({k for p in probes for k in p["collectives"]})
    total = ex.multilinear(
        [(p["point"], _terms(p, kernels, kinds)) for p in probes], plan_full)
    # the peak above the arguments is not affine in any axis: the largest
    # probe's stands for the cell
    temps = [p["memory"]["temp_bytes"] for p in probes]
    total["memory"]["temp_bytes"] = None if None in temps else max(temps)
    shape_note = probes[0].get("shape")
    note = "; ".join(x for x in [
        full_build.note,
        shape_note and "per-PE shape " + ", ".join(
            f"{k} {v}" for k, v in shape_note.items()),
        ex.probe_note([dict(probe_point=p["point"]) for p in probes],
                      plan_full),
        *_caveats(arch, shape, plan_full), *abandoned,
        "temp bytes: the largest probe's" if plan_full else ""] if x)
    return dict(family=arch.family, probes=probes, total=total,
                model_flops=full_build.model_flops, note=note,
                full_point=plan_full, pes=int(cli.get("pes", 4)))


def device_info(device) -> Dict[str, Any]:
    """The card as ``nvidia-smi`` names it, with its power limit; or the
    CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dict(platform="cpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                nvidia_smi=smi.stdout.strip())


def _mesh_scale(cell: Dict[str, Any], mesh_kind: str) -> float:
    """The factor from the counted run to the mesh's whole step: 1, but
    for MWIS, whose counted instance has ``pes`` PEs and whose mesh runs
    one PE a chip (all ``pes`` on the one card)."""
    if cell["family"] != "mwis" or mesh_kind == "card":
        return 1.0
    return MESH_CHIPS[mesh_kind] / cell["pes"]


def _per_device(terms: Dict[str, Any], scale: float, chips: int):
    def one(v):
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        if v is None or isinstance(v, str):
            return v
        return v * scale / chips
    return one(terms)


def mesh_record(arch_id: str, shape: str, mesh_kind: str,
                cell: Dict[str, Any], terms: Dict[str, Any],
                device: Dict[str, Any], overrides=None) -> Dict[str, Any]:
    """A record in the reference's format for ``terms`` (the cell's total
    or one probe's) on ``mesh_kind``."""
    from repro_torch.analysis import roofline as rl

    chips = MESH_CHIPS[mesh_kind]
    scale = _mesh_scale(cell, mesh_kind)
    dev_terms = _per_device({k: terms[k] for k in (
        "flops", "bytes", "transfer_bytes", "collectives", "memory")},
        scale, chips)
    cost = dict(flops=dev_terms["flops"],
                bytes_accessed=dev_terms["bytes"])
    roof = rl.from_cell({"flops": cost["flops"],
                         "bytes accessed": cost["bytes_accessed"]},
                        dev_terms["collectives"],
                        cell["model_flops"] * scale, chips)
    split = ("terms of the counted run" if chips == 1 else
             f"terms split evenly over {chips} chips (not a sharded "
             f"program)")
    coll = ("collectives: the per-PE path's counted exchanges"
            if cell["family"] == "mwis" else
            "collectives: none counted (one card runs the step unsharded)")
    return dict(
        arch=arch_id, shape=shape, mesh=mesh_kind, n_chips=chips, ok=True,
        run_s=sum(p["run_s"] for p in cell["probes"]),
        memory=dev_terms["memory"], cost=cost,
        collectives=dev_terms["collectives"],
        transfer_bytes=dev_terms["transfer_bytes"],
        roofline=roof.report(),
        kernels=terms["kernels"],
        note="; ".join([cell["note"], split, coll]),
        full_point=cell["full_point"],
        probes=[dict(tag=p["tag"], point=p["point"], run_s=p["run_s"])
                for p in cell["probes"]],
        device=device,
        overrides={k: str(v) for k, v in (overrides or {}).items()},
    )


def summary_line(rec: Dict[str, Any]) -> str:
    """flops, bytes, t_bound, bottleneck, run_s and roofline_fraction of
    a record, per device."""
    rf = rec["roofline"]
    t_bound = max(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])
    return (f"flops/dev={rec['cost']['flops']:.6e} "
            f"bytes/dev={rec['cost']['bytes_accessed']:.6e} "
            f"t_bound={t_bound:.6e} s bottleneck={rf['bottleneck']} "
            f"run_s={rec['run_s']:.3f} "
            f"roofline_fraction={rf['roofline_fraction']:.6f}")


def all_cells():
    from repro_torch.configs import registry

    cells = []
    for arch_id, shape, _ in registry.all_cells(include_skipped=False):
        for mesh_kind in MESH_CHIPS:
            cells.append((arch_id, shape, mesh_kind))
    return cells


def _path(out: str, arch_id: str, shape: str, mesh_kind: str,
          tag: str, probe: str = "") -> str:
    t = f"_{tag}" if tag else ""
    p = f"_probe{probe}" if probe else ""
    return os.path.join(out, f"{arch_id}__{shape}__{mesh_kind}{p}{t}.json")


def _write(fn: str, rec: Dict[str, Any]) -> None:
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)


def _failed(arch_id, shape, mesh_kind, error, **extra) -> Dict[str, Any]:
    return dict(arch=arch_id, shape=shape, mesh=mesh_kind, ok=False,
                error=error, **extra)


def _run_all(args, passthrough: List[str]) -> None:
    pairs = list(dict.fromkeys((a, s) for a, s, _ in all_cells()))
    failures = 0
    for arch_id, shape in pairs:
        fns = [_path(args.out, arch_id, shape, m, args.tag)
               for m in MESH_CHIPS]
        if all(os.path.exists(fn) for fn in fns) and not args.force:
            print(f"[skip] {arch_id} × {shape}")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch_id, "--shape", shape, "--out", args.out,
               "--mesh", "card", *passthrough]
        print(f"[cell] {arch_id} × {shape} ...", flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            err = None if r.returncode == 0 else r.stderr[-4000:]
        except subprocess.TimeoutExpired:
            err = "timeout"
        if err is None:
            print("  ok" + "".join(
                f"\n  {line}" for line in r.stdout.splitlines()
                if line.startswith("[card]")), flush=True)
            continue
        failures += 1
        for m, fn in zip(MESH_CHIPS, fns):
            _write(fn, _failed(arch_id, shape, m, err))
        print(f"  FAILED: {err.strip().splitlines()[-1] if err else ''}",
              flush=True)
    print(f"dry-run complete; {failures} failures")
    sys.exit(1 if failures else 0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=tuple(MESH_CHIPS), default="single",
                    help="the record to print (all three are written)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ARTIFACTS)
    ap.add_argument("--tag", default="", help="artifact filename suffix "
                    "(perf-iteration variants)")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--probe", action="store_true",
                    help="write only the probe records")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (JSON values)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--pes", type=int, default=4,
                    help="MWIS cells: gloo ranks, one a PE")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.list:
        for c in all_cells():
            print(*c)
        return
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        passthrough = ["--device", args.device, "--pes", str(args.pes),
                       "--seed", str(args.seed)]
        passthrough += ["--tag", args.tag] if args.tag else []
        passthrough += [x for kv in args.override for x in ("--override", kv)]
        _run_all(args, passthrough)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all / --list)")
    from repro_torch.configs import registry

    cli_ov: Dict[str, Any] = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            cli_ov[k] = json.loads(v)
        except json.JSONDecodeError:
            cli_ov[k] = v
    if registry.get(args.arch).family == "mwis":
        cli_ov.setdefault("pes", args.pes)
    try:
        cell = run_cell(args.arch, args.shape, args.device, cli_ov,
                        seed=args.seed)
    except Exception:
        traceback.print_exc()
        for m in MESH_CHIPS:
            _write(_path(args.out, args.arch, args.shape, m, args.tag),
                   _failed(args.arch, args.shape, m,
                           traceback.format_exc()[-4000:]))
        sys.exit(1)
    info = device_info(args.device)
    for m in MESH_CHIPS:
        for p in cell["probes"]:
            rec = mesh_record(args.arch, args.shape, m, cell, p, info,
                              cli_ov)
            rec.update(probe_point=p["point"], run_s=p["run_s"],
                       top_ops=p["top_ops"])
            _write(_path(args.out, args.arch, args.shape, m, args.tag,
                         p["tag"]), rec)
        if args.probe:
            continue
        rec = mesh_record(args.arch, args.shape, m, cell, cell["total"], info,
                          cli_ov)
        _write(_path(args.out, args.arch, args.shape, m, args.tag), rec)
        print(f"[{m}] {args.arch} × {args.shape}: {summary_line(rec)}",
              flush=True)
    if not args.probe:
        print(json.dumps(mesh_record(
            args.arch, args.shape, args.mesh, cell, cell["total"], info,
            cli_ov)["roofline"], indent=1))


if __name__ == "__main__":
    main()
