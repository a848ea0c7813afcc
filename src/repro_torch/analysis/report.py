"""Render the dry-run's tables from its records.

The port of ``repro/analysis/report.py``: the same tables, over the
records ``launch/dryrun.py`` writes (meshes ``single``, ``multi`` and
``card``); the dry-run table's compile column reads ``run_s``, the time of
the counted runs; ``--kind notes`` lists each record's probes and note
(or why it failed).

    python -m repro_torch.analysis.report --dir artifacts/dryrun_torch
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

MESHES = ("single", "multi", "card")


def load(art_dir: str, tag: str = "") -> List[Dict]:
    out = []
    sfx = f"_{tag}.json" if tag else ".json"
    for fn in sorted(glob.glob(os.path.join(art_dir, f"*{sfx}"))):
        base = os.path.basename(fn)[: -len(".json")]
        parts = base.split("__")
        if tag and not base.endswith(f"_{tag}"):
            continue
        if not tag and len(parts) == 3 and "_" in parts[2] and \
                parts[2] not in MESHES:
            continue
        with open(fn) as f:
            out.append(json.load(f))
    return out


def fmt_si(x: float) -> str:
    for div, sfx in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= div:
            return f"{x / div:.2f}{sfx}"
    return f"{x:.1f}"


def _gb(x) -> str:
    return "n/a" if x is None else f"{x / 1e9:.2f}"


def roofline_table(records: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | t_comp(s) | t_mem(s) | t_coll(s) | "
           "bound | useful | roofline_frac | temp(GB) |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if not r.get("ok"):
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAILED |"
            )
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rf['t_compute_s']:.3e} | {rf['t_memory_s']:.3e} "
            f"| {rf['t_collective_s']:.3e} | {rf['bottleneck'][:4]} "
            f"| {rf['useful_fraction']:.3f} "
            f"| {rf['roofline_fraction']:.4f} "
            f"| {_gb(r['memory']['temp_bytes'])} |"
        )
    return "\n".join(rows)


def dryrun_table(records: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | chips | run(s) | args(GB) | "
           "temp(GB) | flops/dev | bytes/dev | coll bytes/dev |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if not r.get("ok"):
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAILED |")
            continue
        m, c = r["memory"], r["cost"]
        coll = sum(r["collectives"].values())
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['n_chips']} "
            f"| {r['run_s']:.1f} | {_gb(m['argument_bytes'])} "
            f"| {_gb(m['temp_bytes'])} | {fmt_si(c['flops'])} "
            f"| {fmt_si(c['bytes_accessed'])} | {fmt_si(coll)} |"
        )
    return "\n".join(rows)


def notes_table(records: List[Dict]) -> str:
    """Each record's probes and note, or the reason it failed (the last
    line of its error)."""
    rows = ["| arch | shape | mesh | probes | note |", "|" + "---|" * 5]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r.get("ok"):
            probes = ", ".join(p["tag"] for p in r.get("probes", []))
            text = r.get("note", "")
        else:
            probes = "FAILED"
            text = r.get("error", "").strip().splitlines()[-1]
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                    f"| {probes} | {text} |")
    return "\n".join(rows)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--kind", default="roofline",
                    choices=("roofline", "dryrun", "notes"))
    args = ap.parse_args()
    recs = load(args.dir, args.tag)
    print(dict(roofline=roofline_table, dryrun=dryrun_table,
               notes=notes_table)[args.kind](recs))


if __name__ == "__main__":
    main()
