"""Render the dry-run's tables from its records.

The port of ``repro/analysis/report.py``: the same tables, over the
records ``launch/dryrun.py`` writes (meshes ``single``, ``multi`` and
``card``); the dry-run table's compile column reads ``run_s``, the time of
the counted runs; ``--kind notes`` lists each record's probes and note
(or why it failed).  ``--kind same --base OLD`` counts the records equal
to another run's in every term, listing those that differ;
``--kind sharded --base OLD`` sets each sharded record beside the other
run's record of the cell and mesh.

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
            f"| {_seconds(r):.1f} | {_gb(m['argument_bytes'])} "
            f"| {_gb(m['temp_bytes'])} | {fmt_si(c['flops'])} "
            f"| {fmt_si(c['bytes_accessed'])} | {fmt_si(coll)} |"
        )
    return "\n".join(rows)


def _seconds(r: Dict) -> float:
    """The counted runs' time: ``run_s`` on a device, ``host_s`` on meta
    (the abstract count)."""
    return r["run_s"] if "run_s" in r else r["host_s"]


def _t_bound(r: Dict) -> float:
    rf = r["roofline"]
    return max(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])


def abstract_table(records: List[Dict], base: List[Dict] = ()) -> str:
    """The ``card`` mesh's records: where each cell was counted (``meta``
    or ``card``), its FLOPs, transcendentals, bytes, t_bound, bottleneck,
    roofline fraction, temp GB and seconds (host seconds on meta), and
    where ``base`` records (another run's) count the cell too, the ratio
    of FLOPs, bytes, t_bound and roofline fraction to theirs."""
    old = {(r["arch"], r["shape"]): r for r in base
           if r.get("ok") and r["mesh"] == "card"}
    rows = ["| arch | shape | counted on | flops | transc | bytes | "
            "t_bound(s) | bound | roofline_frac | temp(GB) | time(s) | "
            "flops / base | bytes / base | t_bound / base | frac / base |",
            "|" + "---|" * 15]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != "card":
            continue
        if not r.get("ok"):
            rows.append(f"| {r['arch']} | {r['shape']} | FAILED |")
            continue
        rf, c = r["roofline"], r["cost"]
        b = old.get((r["arch"], r["shape"]))
        if b is None:
            ratios = "new | new | new | new"
        else:
            bf = b["roofline"]["roofline_fraction"]
            ratios = (
                f"{c['flops'] / b['cost']['flops']:.4f} | "
                f"{c['bytes_accessed'] / b['cost']['bytes_accessed']:.4f} | "
                f"{_t_bound(r) / _t_bound(b):.4f} | "
                + (f"{rf['roofline_fraction'] / bf:.4f}" if bf else "n/a"))
        where = "meta" if r.get("counted_on") == "meta" else "card"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {where} | {c['flops']:.4e} "
            f"| {r.get('transcendentals', 0):.4e} "
            f"| {c['bytes_accessed']:.4e} | {_t_bound(r):.4e} "
            f"| {rf['bottleneck'][:4]} | {rf['roofline_fraction']:.4f} "
            f"| {_gb(r['memory']['temp_bytes'])} | {_seconds(r):.1f} "
            f"| {ratios} |")
    return "\n".join(rows)


#: The terms two runs' records of a cell must agree in to count as the
#: same count (times and notes aside).
TERMS = ("flops_by_class", "transcendentals", "cost", "memory",
         "collectives", "kernels")


def _by_cell(records: List[Dict]) -> Dict:
    return {(r["arch"], r["shape"], r["mesh"]): r for r in records}


def same_table(records: List[Dict], base: List[Dict]) -> str:
    """Each record against the ``base`` run's record of the same cell and
    mesh in :data:`TERMS`: how many are equal, and each that is not (the
    terms that differ), is new or failed."""
    old = _by_cell(base)
    equal, rows = 0, ["| arch | shape | mesh | differs in |", "|---|---|---|---|"]
    for key, r in sorted(_by_cell(records).items()):
        b = old.get(key)
        if b is None or not (r.get("ok") and b.get("ok")):
            why = "new" if b is None else "failed"
            rows.append(f"| {' | '.join(key)} | {why} |")
            continue
        diff = [t for t in TERMS if r.get(t) != b.get(t)]
        if diff:
            rows.append(f"| {' | '.join(key)} | {', '.join(diff)} |")
        else:
            equal += 1
    return f"{equal} of {len(records)} records equal the base's\n" + \
        "\n".join(rows)


def sharded_table(records: List[Dict], base: List[Dict]) -> str:
    """The sharded records (``single`` / ``multi``), per device, against
    the ``base`` run's record of the same cell and mesh (its even split
    where the base did not shard the cell): argument GB (the base's),
    FLOPs and bytes as × the base's, collective bytes, t_collective,
    t_memory, the bottleneck, temp GB and host seconds."""
    old = _by_cell(base)
    rows = ["| arch | shape | mesh | args B (base) | flops × | bytes × | "
            "coll bytes | t_coll s | t_mem s | bound (base) | temp GB | "
            "host_s |", "|" + "---|" * 12]
    for key, r in sorted(_by_cell(records).items()):
        if not r.get("sharded"):
            continue
        if not r.get("ok"):
            rows.append(f"| {' | '.join(key)} | FAILED |")
            continue
        b = old.get(key)
        rf, m = r["roofline"], r["memory"]
        if b is not None and b.get("ok"):
            base_args = f"{b['memory']['argument_bytes']:.3e}"
            fx = f"{r['cost']['flops'] / b['cost']['flops']:.3f}"
            ratio = r["cost"]["bytes_accessed"] / b["cost"]["bytes_accessed"]
            bx = f"{ratio:.3f}"
            bb = b["roofline"]["bottleneck"][:4]
        else:
            base_args, fx, bx, bb = "n/a", "n/a", "n/a", "n/a"
        rows.append(
            f"| {' | '.join(key)} | {m['argument_bytes']:.3e} "
            f"({base_args}) | {fx} | {bx} "
            f"| {sum(r['collectives'].values()):.3e} "
            f"| {rf['t_collective_s']:.3e} | {rf['t_memory_s']:.3e} "
            f"| {rf['bottleneck'][:4]} ({bb}) | {_gb(m['temp_bytes'])} "
            f"| {_seconds(r):.1f} |")
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
                    choices=("roofline", "dryrun", "notes", "abstract",
                             "same", "sharded"))
    ap.add_argument("--base", action="append", default=[],
                    help="--kind abstract: another run's records (a later "
                         "--base wins), to give each cell's FLOPs, bytes, "
                         "t_bound and roofline fraction as a ratio to "
                         "theirs; --kind same: the run each record must "
                         "equal in its terms; --kind sharded: the run whose "
                         "records of the same mesh (an even split where it "
                         "did not shard the cell) each sharded record is "
                         "set beside")
    args = ap.parse_args()
    recs = load(args.dir, args.tag)
    base = [r for d in args.base for r in load(d)]
    if args.kind == "abstract":
        print(abstract_table(recs, base))
        return
    if args.kind in ("same", "sharded"):
        print(dict(same=same_table, sharded=sharded_table)[args.kind](
            recs, base))
        return
    print(dict(roofline=roofline_table, dryrun=dryrun_table,
               notes=notes_table)[args.kind](recs))


if __name__ == "__main__":
    main()
