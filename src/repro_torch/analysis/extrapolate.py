"""Exact roofline terms via probe extrapolation.

The port of ``repro/analysis/extrapolate.py``.  One card holds neither a
pod's batch nor some models' full depth, so the dry-run
(``launch/dryrun.py``) counts each cell's step at reduced values of up to
two axes — the layers, and the batch (for DLRM the table rows) — two
probe points each, and extrapolates.  Every counted term is a sum over
ops whose sizes are affine in each such axis, so

    cost(x) = a + b·x                     (one axis: exact, not a fit)
    cost(x, y) = a + b·x + c·y + d·x·y    (two axes: 2 x 2 probes)

and :func:`multilinear` evaluates it at the full point, one axis after
the other.  Where a term is not affine in an axis the record's note says
so: the MoE capacity rounds; gemma3's global layers are every 6th; at
B 1 a reshape is a view (``launch/dryrun.py``'s caveats).  The abstract
count (the dry-run's default) has no such caveat: it counts every cell
at its full shape on meta tensors, and only
prefill at layer probes of its full batch, which :func:`affine` carries
exactly to the full depth (by layer kind where local and global layers
interleave).
Loop-free families take a single probe verbatim; MWIS probes are one
sweep-round (the reported unit — trip counts are a runtime quantity).

:func:`finalize_cell` reads a cell's probe records and writes
``<arch>__<shape>__<mesh>_final.json`` with the extrapolated terms, as the
reference's does (its ``p2`` / ``p4`` probes are the layer axis at 2, 4).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis import roofline as rl

FULL_LAYERS = {
    "qwen3-moe-235b-a22b": 94, "grok-1-314b": 64, "mistral-nemo-12b": 40,
    "qwen3-32b": 64, "gemma3-1b": 26,
    "equiformer-v2": 12, "dimenet": 6, "gatedgcn": 16,
}


def _load(fn: str) -> Optional[Dict]:
    if not os.path.exists(fn):
        return None
    with open(fn) as f:
        return json.load(f)


def _terms(rec: Dict) -> Dict[str, float]:
    return dict(
        flops=rec["cost"]["flops"],
        mem=rec["cost"]["bytes_accessed"],
        coll=float(sum(rec["collectives"].values())),
    )


def _lerp(v0: Any, v1: Any, x0: float, x1: float, x: float) -> Any:
    """v0 + (v1 - v0) / (x1 - x0) · (x - x0) on every number of two trees
    of one structure (dicts and numbers; strings must agree; None stays
    None)."""
    if isinstance(v0, dict):
        return {k: _lerp(v0[k], v1[k], x0, x1, x) for k in v0}
    if v0 is None or isinstance(v0, str):
        return v0
    return v0 + (v1 - v0) / (x1 - x0) * (x - x0)


def multilinear(samples: List[Tuple[Dict[str, float], Any]],
                target: Dict[str, float]) -> Any:
    """Evaluate at ``target`` the multilinear function through
    ``samples``: ``(point, value)`` pairs on a grid of two values an axis
    (2^k samples for the k axes of ``target``), axes taken in sorted
    order.  A value is a number or a tree of numbers."""
    axes = sorted(target)
    if not axes:
        if len(samples) != 1:
            raise ValueError(f"{len(samples)} probes without a probe axis")
        return samples[0][1]
    axis, rest = axes[0], {a: target[a] for a in axes[1:]}
    xs = sorted({p[axis] for p, _ in samples})
    if len(xs) != 2:
        raise ValueError(f"axis {axis!r} needs two probe points, got {xs}")
    v0, v1 = (multilinear([(p, v) for p, v in samples if p[axis] == x], rest)
              for x in xs)
    return _lerp(v0, v1, xs[0], xs[1], target[axis])


def affine(samples: List[Tuple[Dict[str, float], Any]],
           target: Dict[str, float]) -> Any:
    """Evaluate at ``target`` the affine function a + Σ b_axis · x_axis
    through ``samples`` (``(point, value)`` pairs, one more than the axes
    of ``target``, in general position): Σ c_i · value_i with the weights
    c that carry the samples' points to ``target``.  Exact where the
    weights are integers (the dry-run's layer-kind probes).  A value is a
    number or a tree of numbers."""
    from fractions import Fraction

    axes = sorted(target)
    if len(samples) != len(axes) + 1:
        raise ValueError(f"{len(samples)} probes for {len(axes)} axes")
    # rows: [1, x_axis...] of each sample; solve rows^T c = [1, target...]
    a = [[Fraction(1)] + [Fraction(p[ax]) for ax in axes] for p, _ in samples]
    m = [[a[i][j] for i in range(len(a))] + [Fraction(
        1 if j == 0 else target[axes[j - 1]])] for j in range(len(a))]
    n = len(m)
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col] != 0), None)
        if piv is None:
            raise ValueError(f"probe points {[p for p, _ in samples]} do "
                             f"not determine {axes}")
        m[col], m[piv] = m[piv], m[col]
        for r in range(n):
            if r != col and m[r][col] != 0:
                f = m[r][col] / m[col][col]
                m[r] = [x - f * y for x, y in zip(m[r], m[col])]
    weights = [m[i][n] / m[i][i] for i in range(n)]
    return _combine([v for _, v in samples], weights)


def _combine(values: List[Any], weights: List[Any]) -> Any:
    """Σ weights_i · values_i over trees of one structure (ints stay ints
    where every weight is an integer)."""
    v0 = values[0]
    if isinstance(v0, dict):
        return {k: _combine([v[k] for v in values], weights) for k in v0}
    if v0 is None or isinstance(v0, str):
        return v0
    total = sum(w * v for w, v in zip(weights, values))
    if all(w.denominator == 1 for w in weights) and all(
            isinstance(v, int) for v in values):
        return int(total)
    return float(total)


def _probe_point(rec: Dict) -> Dict[str, float]:
    """The port's probes carry ``probe_point``; the reference's layer
    probes carry ``probe_layers`` (None for a loop-free probe)."""
    if "probe_point" in rec:
        return rec["probe_point"]
    layers = rec.get("probe_layers")
    return {} if layers is None else {"n_layers": layers}


def finalize_cell(art_dir: str, arch: str, shape: str,
                  mesh: str) -> Optional[Dict]:
    stem = os.path.join(art_dir, f"{arch}__{shape}__{mesh}")
    base = _load(f"{stem}.json")
    if not base or not base.get("ok"):
        return None
    probes = {}
    for fn in sorted(glob.glob(f"{stem}_probe*.json")):
        tag = os.path.basename(fn)[len(os.path.basename(stem)) + 6:-5]
        rec = _load(fn)
        if "_" not in tag and rec.get("ok"):
            probes[tag] = rec
    if "p2" in probes and "p4" in probes:     # the reference's layer probes
        probes = {t: probes[t] for t in ("p2", "p4")}
    elif "p1" in probes or "sweep" in probes:
        probes = {t: probes[t] for t in ("p1", "sweep") if t in probes}
        probes = dict([next(iter(probes.items()))])
    if not probes:
        return None
    samples = [(_probe_point(r), _terms(r)) for r in probes.values()]
    target = base.get("full_point")
    if target is None:
        axes = {a for p, _ in samples for a in p}
        target = {"n_layers": FULL_LAYERS[arch]} if axes else {}
    try:
        ext = multilinear(samples, target)
    except ValueError:
        return None
    if list(probes) == ["p1"]:
        note = "loop-free arch: probe cost is exact"
    elif list(probes) == ["sweep"]:
        note = "MWIS: per sweep-round unit (dynamic trip counts)"
    elif sorted(probes) == ["p2", "p4"]:
        note = (f"extrapolated from unrolled probes L=2,4 -> "
                f"L={target['n_layers']}")
    else:
        note = probe_note(list(probes.values()), target)
    roof = rl.Roofline(
        flops=ext["flops"], mem_bytes=ext["mem"], coll_bytes=ext["coll"],
        model_flops=base["roofline"]["model_flops_per_device"],
    )
    out = dict(base)
    out["roofline"] = roof.report()
    out["cost"] = dict(flops=ext["flops"], bytes_accessed=ext["mem"])
    out["collectives"] = {"extrapolated_total": int(ext["coll"])}
    out["note"] = (out.get("note", "") + "; " + note).strip("; ")
    with open(f"{stem}_final.json", "w") as f:
        json.dump(out, f, indent=1)
    return out


def probe_note(probes: List[Dict], target: Dict[str, float]) -> str:
    """Names every reduced axis, its probe points and its full value."""
    if not target:
        return "single probe: its count is the cell's"
    parts = []
    for axis in sorted(target):
        xs = sorted({_probe_point(r)[axis] for r in probes})
        parts.append(f"{axis}={','.join(str(x) for x in xs)} -> "
                     f"{target[axis]}")
    return ("extrapolated multilinearly from probes " + "; ".join(parts))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args()
    done, missing = 0, []
    for fn in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        b = os.path.basename(fn)[:-5]
        parts = b.split("__")
        if len(parts) != 3 or "_probe" in parts[2] or "_final" in parts[2]:
            continue
        arch, shape, mesh = parts
        if finalize_cell(args.dir, arch, shape, mesh):
            done += 1
        else:
            missing.append((arch, shape, mesh))
    print(f"finalized {done} cells; missing probes for {len(missing)}")
    for m in missing[:20]:
        print("  missing:", *m)


if __name__ == "__main__":
    main()
