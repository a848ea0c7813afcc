"""Dry-run: count every (arch × shape) cell's step and score it against the
H100 roofline.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step for a TPU pod of 256 (``single``) or 512 (``multi``)
placeholder devices and reads XLA's cost and memory analyses.  The port has
no compiler and no GSPMD: it RUNS each cell's step once under
``analysis.count.WorkCounter``.

By default (the abstract count; ``--abstract`` names it) LM, GNN and DLRM
cells run on meta tensors, as the reference lowers its cells: the weights
from ``models.common.abstract_params``, the optimizer state from
``configs.base.opt_abstract``, the inputs from ``configs.base.sds`` (index
arrays whose data sets work drawn on the host beside them), so a cell
holds no memory, needs no card and is counted at its full shape.
Training, decode, GNN and DLRM cells are counted in one run at full shape
and depth.  Prefill cells (a Python tile loop a layer, slow at full depth)
are counted at full batch, seq and width at the reference's layer probes
L 2, 4 and extrapolated in L, which is exact for uniform layers without a
backward; gemma3, whose every 6th layer is global, at L 1, 2, 6, combined
by layer kind (``analysis.extrapolate.affine``).

On the production meshes (``single``, 256 chips; ``multi``, 512) an LM
or DLRM cell is also counted as a sharded program, as the reference
compiles one SPMD program: ``launch.mesh.make_production_mesh`` makes
the reference's mesh over an in-process fake process group, this process
rank 0; the inputs are meta DTensors laid out as the reference's
``in_shardings`` (``make_inputs(..., mesh)``), the reference's activation
hints are installed (``models.common.set_hint_mesh``), and the work
counter counts rank 0's local ops and the collectives DTensor issues
(``analysis.count``).  LM cells at the reference's layer probes (L 2, 4;
gemma3 L 1, 2, 6 by layer kind), DLRM in one run.  An op DTensor cannot
shard raises, and the mesh's record then says ``ok: false`` and why
(exit code :data:`SHARDED_FAILED`); nothing falls back to the even split.
GNN cells keep the even split of the unsharded count on those meshes.

MWIS cells count one sweep-round of the per-PE path
(``solvers.sweep_probe_shard_map_fn``) on ``--pes`` gloo ranks over an
instance at the cell's per-PE shape, on ``--device``: a sweep-round's work
is its data's.

``--probes`` asks for the card route that came first and is superseded:
LM, GNN and DLRM cells run on ``--device`` at full width at two probe
points of up to two reduced axes — the layers (the reference's L = 2, 4
where they fit, else 1, 2), the batch (LM train and prefill: 1, 2; decode
keeps its batch where it fits) and DLRM's table rows (every table capped
at 1 M and 2 M rows) — extrapolated multilinearly to the full cell
(``analysis.extrapolate``).  A probe plan that runs out of the card's
memory gives way to the next, smaller one; a cell that fits at none gets
a record with ``ok: false`` and the reason.  Such a record says
``superseded_by: "abstract"`` and starts its note with
:data:`SUPERSEDED`: at B 1, 2 the probes overcount bytes and miss the
MoE capacity at the full batch.

Per cell and mesh (``single`` 256 chips, ``multi`` 512, ``card`` 1) the
record holds the counted FLOPs and bytes (``cost``), the transcendentals
beside them (``transcendentals``), the FLOPs by op class
(``flops_by_class``) and the collective bytes per device (rank 0's of a
sharded program, with ``collective_calls`` by kind; a GNN cell's split
evenly over the chips), the per-device memory, the three roofline terms and bottleneck (``analysis.roofline``,
H100 SXM5), the model FLOPs (the reference's formulas), ``run_s`` (the
counted runs' device time; ``host_s``, their host time, on meta),
``counted_on`` (``meta``, ``cpu``, or the card's name and power limit)
and the card's name and power limit.  The roofline's collective term
takes ``analysis.roofline.LINK_BW``, the NVLink rate inside one 8-card
node, also where a mesh spans nodes.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
      --mesh card
  python -m repro_torch.launch.dryrun --all            # a subprocess a cell
  python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k
                                                 # meta: no card needed
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
      --mesh single          # the record of the sharded program, 256 ranks
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k \\
      --probes --device cpu --override d_model=64 ...  # the probe route

The reference's ``XLA_FLAGS`` preamble (512 host devices) has no
counterpart.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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
        flops=rec["flops"], transcendentals=rec["transcendentals"],
        flops_by_class=dict(rec["flops_by_class"]), bytes=rec["bytes"],
        transfer_bytes=rec["transfer_bytes"],
        collectives={k: rec["collectives"].get(k, 0) for k in kinds},
        kernels={k: dict(units=ks.get(k, {}).get("units", 0),
                         ops=ks.get(k, {}).get("ops", 0),
                         bytes=ks.get(k, {}).get("bytes", 0), op_class=c)
                 for k, c in kernels.items()},
        memory=dict(rec["memory"]),
        **({"collective_calls": {k: rec["collective_calls"].get(k, 0)
                                 for k in kinds}}
           if "collective_calls" in rec else {}),
    )


def _run_probe(arch, shape: str, tag: str, ov: Dict[str, Any],
               point: Dict[str, int], device, seed: int,
               mesh=None) -> Dict[str, Any]:
    """One counted run of the cell's step at one probe point; with a
    ``mesh``, one rank's run of the sharded program on meta DTensors
    (plain tensors the step makes count as replicated)."""
    from repro_torch.analysis import count

    built = arch.build(shape, ov)
    if built.measure is not None:
        _, rec = built.measure(device, seed)
    else:
        inputs = (built.make_inputs(device, seed) if mesh is None
                  else built.make_inputs(device, seed, mesh))
        _, rec = count.measure(built.fn, inputs, device)
        del inputs
    calls = collections.Counter(k for k, _ in rec.pop("collective_ops", []))
    if mesh is not None:
        rec["collective_calls"] = dict(sorted(calls.items()))
    by_op = rec.pop("by_op", {})
    rec["top_ops"] = dict(sorted(by_op.items(), key=lambda kv: -kv[1][2])[
        :TOP_OPS])
    rec["ops_without_flops"] = sorted(op for op, v in by_op.items()
                                      if not (v[1] or v[3]))
    return dict(tag=tag, point=point, overrides=ov, **rec)


def _free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


#: Families counted as a sharded program on the production meshes (the
#: GNNs' terms are still split evenly; MWIS counts its per-PE program).
SHARDED_FAMILIES = ("lm", "recsys")
#: The production meshes, by whether they span two pods.
_MULTI_POD = {"single": False, "multi": True}

#: Archs whose FFN routes tokens to experts at a capacity.
_MOE = ("qwen3-moe-235b-a22b", "grok-1-314b")

#: The note of an LM, GNN or DLRM cell counted on a device by probes.
SUPERSEDED = ("superseded by the abstract count (the default), the "
              "full-shape count on meta: these probes extrapolate, with "
              "the caveats below")


def _layer_kinds(cfg, n_layers: int) -> Dict[str, int]:
    """Local and global layers of ``n_layers`` under ``cfg``'s interleave
    (every ``global_every``-th layer global)."""
    n_global = n_layers // cfg.global_every
    return {"local_layers": n_layers - n_global, "global_layers": n_global}


def _layer_plan(arch, cfg) -> Tuple[List[Probe], Dict[str, int]]:
    """The reference's layer probes of an LM cell and its full point: L 2,
    4, or for an interleave of local and global layers L 1, 2 and
    max(global_every, 3), one point a layer kind."""
    from repro_torch.analysis.extrapolate import FULL_LAYERS

    full = FULL_LAYERS[arch.arch_id]
    if cfg.local_window and cfg.global_every > 1:
        ls = sorted({1, 2, max(cfg.global_every, 3)})
        return ([(f"L{n}", {"n_layers": n}, _layer_kinds(cfg, n))
                 for n in ls], _layer_kinds(cfg, full))
    return ([(f"L{n}", {"n_layers": n}, {"n_layers": n}) for n in (2, 4)],
            {"n_layers": full})


def _abstract_plan(arch, shape: str, cfg, pinned=()
                   ) -> Tuple[List[Probe], Dict[str, int]]:
    """The abstract count's probes and full point.  A prefill cell: the
    reference's layer probes (:func:`_layer_plan`); every other cell one
    run at its full shape (``full``).  A pinned layer count is not
    probed."""
    from repro_torch.configs import base

    if (arch.family != "lm" or base.LM_SHAPES[shape]["kind"] != "prefill"
            or "n_layers" in pinned):
        return [("full", {}, {})], {}
    return _layer_plan(arch, cfg)


def _sharded_plan(arch, cfg, pinned=()
                  ) -> Tuple[List[Probe], Dict[str, int]]:
    """The sharded count's probes and full point: an LM cell at the
    reference's layer probes (:func:`_layer_plan`; every layer's work,
    collectives, shards and saved residuals alike, so the count is
    affine in the layers of each kind), DLRM one run."""
    if arch.family != "lm" or "n_layers" in pinned:
        return [("full", {}, {})], {}
    return _layer_plan(arch, cfg)


def _caveats(arch, shape: str, point: Dict[str, int]) -> List[str]:
    """Terms the probes cannot extrapolate exactly, and why."""
    from repro_torch.configs import base

    out = []
    if "batch" in point:
        out.append("at B 1 a reshape is a view where at B >= 2 it is a "
                   "copy (aten.clone), so the bytes extrapolated from "
                   "probes at B 1, 2 overshoot (the abstract count takes "
                   "the full batch)")
    if arch.arch_id in _MOE and "batch" in point:
        out.append("MoE capacity = round(tokens*k/E*1.25) is not affine in "
                   "the batch: the dispatch buffers' terms are approximate")
    if arch.arch_id == "gemma3-1b" and "n_layers" in point:
        out.append("the probes' layers are all local (every 6th of 26 is "
                   "global): the full depth is counted as local layers")
    if ("table_rows" in point
            and base.RECSYS_SHAPES[shape]["kind"] == "train"):
        out.append("ids are drawn below each capped vocabulary, so the "
                   "backward kernel's touched rows are the capped tables'")
    return out


def _abstract_cell(arch, shape: str, full_build, cli: Dict[str, Any],
                   seed: int, sharded=tuple(_MULTI_POD)) -> Dict[str, Any]:
    """``run_cell``'s abstract route: the cell counted on meta at its full
    shape (prefill: at its layer probes, combined exactly); an LM or DLRM
    cell also as a sharded program on each production mesh of
    ``sharded`` (``cell["sharded"][mesh]``, :func:`_sharded_count`)."""
    from repro_torch.analysis import extrapolate as ex

    plan, full_point = _abstract_plan(arch, shape, full_build.cfg,
                                      pinned=tuple(cli))
    probes = [_run_probe(arch, shape, tag, dict(ov, **cli), pt, "meta",
                         seed) for tag, ov, pt in plan]
    kernels = {k: v["op_class"] for p in probes
               for k, v in p.get("kernels", {}).items()}
    kinds = sorted({k for p in probes for k in p["collectives"]})
    total = ex.affine([(p["point"], _terms(p, kernels, kinds))
                       for p in probes], full_point)
    total["memory"]["temp_bytes"] = max(p["memory"]["temp_bytes"]
                                        for p in probes)
    how = "counted on meta in one run at the full shape"
    if full_point:
        how = (f"counted on meta at full batch, seq and width at layer "
               f"probes {', '.join(t for t, _, _ in plan)}, carried exactly "
               f"to {full_point} (layers of one kind alike, no backward); "
               f"temp bytes: the largest probe's")
    cell = dict(family=arch.family, probes=probes, total=total,
                model_flops=full_build.model_flops,
                note="; ".join(x for x in [full_build.note, how] if x),
                build_note=full_build.note, full_point=full_point,
                counted_on="meta")
    if arch.family in SHARDED_FAMILIES and sharded:
        from repro_torch.launch.mesh import release_fake_world

        try:
            cell["sharded"] = {m: _sharded_count(arch, shape, full_build,
                                                 cli, seed, m)
                               for m in sharded}
        finally:
            release_fake_world()
    return cell


#: The exit code of a cell whose sharded count failed on a mesh (its
#: records written, that mesh's with ``ok: false``).
SHARDED_FAILED = 3


@contextlib.contextmanager
def sharded_scope(mesh):
    """Within: one rank's count of a sharded program on ``mesh`` — the
    reference's activation hints on ``mesh`` (``models.common.
    set_hint_mesh``), a work counter that counts that rank's local work
    and collectives (``analysis.count.capture_dtensor``), and the plain
    tensors a step makes taken as replicated (``implicit_replication``).
    Everything is as it was on exit."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis import count
    from repro_torch.models import common as MC

    MC.set_hint_mesh(mesh)
    try:
        with count.capture_dtensor(), implicit_replication():
            yield
    finally:
        MC.set_hint_mesh(None)


def _sharded_count(arch, shape: str, full_build, cli: Dict[str, Any],
                   seed: int, mesh_kind: str) -> Dict[str, Any]:
    """The cell as a sharded program on ``mesh_kind``'s production mesh
    (``launch.mesh.make_production_mesh``: a fake process group of 256 or
    512 ranks, this process rank 0), counted on rank 0 on meta DTensors
    laid out as the reference's ``in_shardings`` (``make_inputs(...,
    mesh)``) with the reference's activation hints installed
    (:func:`sharded_scope`): {probes, total (rank 0's terms),
    full_point, note}, or {error} where the count failed (an op DTensor
    cannot shard raises; nothing falls back to the even split)."""
    from repro_torch.analysis import extrapolate as ex
    from repro_torch.launch.mesh import make_production_mesh

    plan, full_point = _sharded_plan(arch, full_build.cfg, pinned=tuple(cli))
    try:
        mesh = make_production_mesh(multi_pod=_MULTI_POD[mesh_kind])
        with sharded_scope(mesh):
            probes = [_run_probe(arch, shape, tag, dict(ov, **cli), pt,
                                 "meta", seed, mesh=mesh)
                      for tag, ov, pt in plan]
    except Exception:
        return dict(error=traceback.format_exc()[-4000:])
    kernels = {k: v["op_class"] for p in probes
               for k, v in p.get("kernels", {}).items()}
    kinds = sorted({k for p in probes for k in p["collectives"]})
    total = ex.affine([(p["point"], _terms(p, kernels, kinds))
                       for p in probes], full_point)
    how = "counted in one run at the full shape"
    if full_point:
        how = (f"counted at layer probes {', '.join(t for t, _, _ in plan)}"
               f", carried exactly to {full_point} (layers of one kind "
               f"alike: their work, collectives and saved residuals)")
    return dict(probes=probes, total=total, full_point=full_point,
                note=how)


def run_cell(arch_id: str, shape: str, device="cuda",
             overrides: Optional[Dict[str, Any]] = None, seed: int = 0,
             abstract: bool = True,
             sharded=tuple(_MULTI_POD)) -> Dict[str, Any]:
    """Count ``arch_id × shape``: {probes (their counts), total (the full
    cell's counted terms), model_flops, note, full_point, family,
    counted_on}.  An LM, GNN or DLRM cell is counted on meta at its full
    shape (``device`` is not used); with ``abstract=False`` (the
    superseded probe route) at its probe points on ``device``,
    extrapolated.  An MWIS cell is counted on ``device`` either way.
    On the abstract route an LM or DLRM cell is also counted as a
    sharded program on each production mesh of ``sharded``
    (``cell["sharded"]``)."""
    from repro_torch import resolve_device
    from repro_torch.analysis import extrapolate as ex
    from repro_torch.configs import registry

    import torch

    arch = registry.get(arch_id)
    if shape not in arch.shapes:
        why = arch.skips.get(shape, "not a shape of this arch")
        raise ValueError(f"{arch_id} × {shape}: {why}")
    cli = dict(overrides or {})
    full_build = arch.build(shape, cli or None)
    if abstract and arch.family != "mwis":
        return _abstract_cell(arch, shape, full_build, cli, seed, sharded)
    dev = resolve_device(device)
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
    cell = dict(family=arch.family, probes=probes, total=total,
                model_flops=full_build.model_flops, note=note,
                full_point=plan_full, pes=int(cli.get("pes", 4)),
                counted_on=dev.type)
    if arch.family != "mwis":
        cell.update(superseded_by="abstract", note=SUPERSEDED + "; " + note)
    return cell


def device_info(device) -> Dict[str, Any]:
    """The card as ``nvidia-smi`` names it, with its power limit; or the
    CPU, or meta (no device)."""
    import torch

    dev = torch.device(device)
    if dev.type == "meta":
        return dict(platform="meta")
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
    or one probe's) on ``mesh_kind``.  A cell counted sharded on
    ``mesh_kind`` gives :func:`_sharded_record` (its total there for the
    cell's total)."""
    from repro_torch.analysis import roofline as rl

    chips = MESH_CHIPS[mesh_kind]
    sharded = cell.get("sharded", {}).get(mesh_kind)
    if sharded is not None:
        if "total" in sharded and terms is cell.get("total"):
            terms = sharded["total"]     # the cell's total on that mesh
        return _sharded_record(arch_id, shape, mesh_kind, cell, sharded,
                               terms, device, overrides)
    scale = _mesh_scale(cell, mesh_kind)
    dev_terms = _per_device({k: terms[k] for k in (
        "flops", "transcendentals", "flops_by_class", "bytes",
        "transfer_bytes", "collectives", "memory")}, scale, chips)
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
    clock = _clock(cell["probes"][0])
    counted_on = cell.get("counted_on", "cuda")
    if counted_on == "cuda":
        counted_on = device.get("nvidia_smi") or device.get("kind", "cuda")
    return {
        **dict(arch=arch_id, shape=shape, mesh=mesh_kind, n_chips=chips,
               ok=True),
        clock: sum(p[clock] for p in cell["probes"]),
        **dict(
            memory=dev_terms["memory"], cost=cost,
            transcendentals=dev_terms["transcendentals"],
            flops_by_class=dev_terms["flops_by_class"],
            collectives=dev_terms["collectives"],
            transfer_bytes=dev_terms["transfer_bytes"],
            roofline=roof.report(),
            kernels=terms["kernels"],
            note="; ".join([cell["note"], split, coll]),
            full_point=cell["full_point"],
            probes=[{"tag": p["tag"], "point": p["point"], clock: p[clock]}
                    for p in cell["probes"]],
            counted_on=counted_on,
            **({"superseded_by": cell["superseded_by"]}
               if "superseded_by" in cell else {}),
            device=device,
            overrides={k: str(v) for k, v in (overrides or {}).items()},
        )}


def _sharded_record(arch_id: str, shape: str, mesh_kind: str,
                    cell: Dict[str, Any], sharded: Dict[str, Any],
                    terms: Dict[str, Any], device: Dict[str, Any],
                    overrides=None) -> Dict[str, Any]:
    """:func:`mesh_record` of a cell counted as a sharded program on
    ``mesh_kind`` (``_sharded_count``): ``terms`` are rank 0's own (the
    sharded total, or one of its probes); a failed count gives a record
    with ``ok: false`` and the reason."""
    from repro_torch.analysis import roofline as rl

    chips = MESH_CHIPS[mesh_kind]
    if "error" in sharded:
        return _failed(arch_id, shape, mesh_kind, sharded["error"],
                       n_chips=chips, counted_on="meta",
                       note=f"the sharded count on {chips} ranks failed")
    cost = dict(flops=terms["flops"], bytes_accessed=terms["bytes"])
    roof = rl.from_cell({"flops": cost["flops"],
                         "bytes accessed": cost["bytes_accessed"]},
                        terms["collectives"], cell["model_flops"], chips)
    clock = _clock(sharded["probes"][0])
    note = "; ".join(x for x in [
        cell["build_note"], f"a sharded program on {chips} ranks (DTensor, fake process "
        f"group), counted on rank 0 on meta", sharded["note"],
        "collectives: rank 0's, by their output bytes (hlo.py's "
        "convention); the collective term at LINK_BW, the NVLink rate "
        "inside one 8-card node, also where the mesh spans nodes"] if x)
    return {
        **dict(arch=arch_id, shape=shape, mesh=mesh_kind, n_chips=chips,
               ok=True),
        clock: sum(p[clock] for p in sharded["probes"]),
        **dict(
            memory=dict(terms["memory"]), cost=cost,
            transcendentals=terms["transcendentals"],
            flops_by_class=dict(terms["flops_by_class"]),
            collectives=dict(terms["collectives"]),
            collective_calls=dict(terms.get("collective_calls", {})),
            transfer_bytes=terms["transfer_bytes"],
            roofline=roof.report(),
            kernels=terms["kernels"],
            note=note,
            full_point=sharded["full_point"],
            probes=[{"tag": p["tag"], "point": p["point"], clock: p[clock]}
                    for p in sharded["probes"]],
            counted_on="meta", sharded=True,
            device=device,
            overrides={k: str(v) for k, v in (overrides or {}).items()},
        )}


def _clock(rec: Dict[str, Any]) -> str:
    """The time a record or probe carries: ``run_s`` (a device's run) or
    ``host_s`` (an abstract count, on the host's clock)."""
    return "host_s" if "host_s" in rec else "run_s"


def summary_line(rec: Dict[str, Any]) -> str:
    """flops, transcendentals, bytes, t_bound, bottleneck, run_s (host_s
    on meta) and roofline_fraction of a record, per device."""
    rf = rec["roofline"]
    t_bound = max(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])
    clock = _clock(rec)
    return (f"flops/dev={rec['cost']['flops']:.6e} "
            f"transcendentals/dev={rec['transcendentals']:.6e} "
            f"bytes/dev={rec['cost']['bytes_accessed']:.6e} "
            f"t_bound={t_bound:.6e} s bottleneck={rf['bottleneck']} "
            f"{clock}={rec[clock]:.3f} "
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


def _run_one(args, passthrough: List[str], arch_id: str, shape: str
             ) -> bool:
    """One cell in a subprocess; its records (or failed ones) written and
    its result printed.  True if it counted."""
    fns = [_path(args.out, arch_id, shape, m, args.tag) for m in MESH_CHIPS]
    if all(os.path.exists(fn) for fn in fns) and not args.force:
        print(f"[skip] {arch_id} × {shape}", flush=True)
        return True
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch_id, "--shape", shape, "--out", args.out,
           "--mesh", "card", *passthrough]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=args.timeout)
        err = (None if r.returncode in (0, SHARDED_FAILED)
               else r.stderr[-4000:])
    except subprocess.TimeoutExpired:
        err = "timeout"
    if err is None:
        ok = r.returncode == 0
        print(f"[cell] {arch_id} × {shape}: "
              f"{'ok' if ok else 'a sharded count FAILED'}" + "".join(
                  f"\n  {line}" for line in r.stdout.splitlines()
                  if line.startswith("[")), flush=True)
        return ok
    for m, fn in zip(MESH_CHIPS, fns):
        _write(fn, _failed(arch_id, shape, m, err))
    print(f"[cell] {arch_id} × {shape}: FAILED: "
          f"{err.strip().splitlines()[-1] if err else ''}", flush=True)
    return False


def _run_all(args, passthrough: List[str]) -> None:
    """Every cell, a subprocess each.  The meta cells (host work, one core
    each, no device; all but MWIS unless ``--probes``) run several at a
    time, two cores left to the host, then the other cells one at a time
    on the device."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import registry

    pairs = list(dict.fromkeys((a, s) for a, s, _ in all_cells()))
    pooled = [c for c in pairs if not args.probes
              and registry.get(c[0]).family != "mwis"]
    with ThreadPoolExecutor(max(1, (os.cpu_count() or 3) - 2)) as pool:
        ok = list(pool.map(lambda c: _run_one(args, passthrough, *c),
                           pooled))
    ok += [_run_one(args, passthrough, *c) for c in pairs
           if c not in pooled]
    failures = ok.count(False)
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
                    help="cuda (default) or cpu: MWIS cells, and the "
                         "others under --probes")
    route = ap.add_mutually_exclusive_group()
    route.add_argument("--abstract", action="store_true",
                       help="the default: LM, GNN and DLRM cells counted "
                            "on meta tensors at their full shape")
    route.add_argument("--probes", action="store_true",
                       help="count LM, GNN and DLRM cells by probes on "
                            "--device, extrapolated (superseded by the "
                            "abstract count)")
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
        passthrough += ["--probes"] if args.probes else []
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
                        seed=args.seed, abstract=not args.probes)
    except Exception:
        traceback.print_exc()
        for m in MESH_CHIPS:
            _write(_path(args.out, args.arch, args.shape, m, args.tag),
                   _failed(args.arch, args.shape, m,
                           traceback.format_exc()[-4000:]))
        sys.exit(1)
    info = device_info("meta" if cell["counted_on"] == "meta"
                       else args.device)
    failed = []
    for m in MESH_CHIPS:
        sharded = cell.get("sharded", {}).get(m)
        if sharded is not None and "error" in sharded:
            failed.append(m)
            rec = mesh_record(args.arch, args.shape, m, cell, cell["total"],
                              info, cli_ov)
            _write(_path(args.out, args.arch, args.shape, m, args.tag), rec)
            print(f"[{m}] {args.arch} × {args.shape}: FAILED: "
                  f"{sharded['error'].strip().splitlines()[-1]}",
                  flush=True)
            continue
        for p in (cell["probes"] if sharded is None
                  else sharded["probes"]):
            rec = mesh_record(args.arch, args.shape, m, cell, p, info,
                              cli_ov)
            clock = _clock(p)
            rec.update({"probe_point": p["point"], clock: p[clock],
                        "top_ops": p["top_ops"],
                        "ops_without_flops": p["ops_without_flops"]})
            _write(_path(args.out, args.arch, args.shape, m, args.tag,
                         p["tag"]), rec)
        if args.probe:
            continue
        rec = mesh_record(args.arch, args.shape, m, cell, cell["total"],
                          info, cli_ov)
        _write(_path(args.out, args.arch, args.shape, m, args.tag), rec)
        print(f"[{m}] {args.arch} × {args.shape}: {summary_line(rec)}",
              flush=True)
        if m == args.mesh and not args.probe:
            shown = rec["roofline"]
    if not args.probe and args.mesh not in failed:
        print(json.dumps(shown, indent=1))
    if failed:
        sys.exit(SHARDED_FAILED)


if __name__ == "__main__":
    main()
