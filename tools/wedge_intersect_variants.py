#!/usr/bin/env python3
"""Time designs of the ``wedge_intersect`` CUDA kernel on one card.

    python3 tools/wedge_intersect_variants.py [--n 1048576] [--reps 50]

The instance is ``chip_smoke.py``'s: the union problem of RGG n = 2^20,
p = 4 (window cap 16), with the initial state and the state after
DisReduA (reduce/cheap-fused; active = UNDECIDED).  Every variant has the
C interface of ``src/repro_torch/kernels/wedge_intersect/csrc/
wedge_intersect.cu`` and is built with one ``nvcc`` each, all started
together:

  * the committed kernel, the same with 256 threads a block, with every
    activity and weight of W(row) loaded before the compares, and without
    those gathers (its C and K are not the function's);
  * the first design (``tools/variants/wedge_first.cu``: the same
    all-pairs compare, with a branch around each entry's two gathers), and
    the same without its compares, loads only;
  * designs that use the partition's ascending windows to compare less, in
    ``tools/variants/``: a lookup by blocks of four (``wedge_blocks.cu``),
    a binary lower-bound search through shared memory
    (``wedge_lookup.cu``) and a merge through shared memory
    (``wedge_merge.cu``), each with an all-pairs path for a W(col) that is
    not ascending; and the warp-cooperative ``__match_any_sync``
    (``wedge_match.cu``).

Each is run on the real edges and with ``col := row`` (so W(col) is the
row's own, already-cached window), in both states.  Every variant that
computes the function must give the plain version's bits on its inputs.
Prints the card, then each (state, input) pair's mean CUDA-event time per
variant, timed in the order given and again in reverse, and the edges that
took the all-pairs path of each variant that has one.  ``--sass`` first
prints, for each library, the instruction counts by opcode of its D = 16
kernels.  Exits non-zero on any failure or without a card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
HERE = Path(__file__).resolve().parent / "variants"

_FIRST = HERE / "wedge_first.cu"
_COMPARE = """  unsigned c = 0;  // unsigned: wraps like the reference's int32 sum
  int k = 0;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {"""
_LOADS_ONLY = """  unsigned c = 0;  // loads only: every entry consumed, nothing compared
  int k = 0;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) c += (unsigned)(u[i] ^ v[i]);
#pragma unroll
  for (int i = 0; i < 0; ++i) {"""
_GATHERS = """    act[i] = (EXACT || i < d) && hit && active[u[i]] != 0;"""
_NO_GATHERS = """    act[i] = (EXACT || i < d) && hit;"""
_WEIGHTS = """    c += act[i] ? (unsigned)weights[u[i]] : 0u;"""
_ACT = """  bool act[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {"""
_ACT_FIRST = """  bool first_a[DMAX];  // every activity and weight loaded before the test
  int first_w[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    first_a[i] = (EXACT || i < d) && active[u[i]] != 0;
    first_w[i] = (EXACT || i < d) ? weights[u[i]] : 0;
  }
  bool act[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {"""

#: tag -> (source (None: the committed one), [(its text, the replacement)],
#: checked against the plain version)
VARIANTS = {
    "committed": (None, [], True),
    "256 threads a block": (None, [("constexpr int kThreads = 128;",
                                    "constexpr int kThreads = 256;")], True),
    "gathers first": (None, [
        (_ACT, _ACT_FIRST),
        (_GATHERS, "    act[i] = (EXACT || i < d) && hit && first_a[i];"),
        (_WEIGHTS, "    c += act[i] ? (unsigned)first_w[i] : 0u;")], True),
    "no gathers": (None, [(_GATHERS, _NO_GATHERS),
                          (_WEIGHTS, "    c += act[i] ? (unsigned)u[i] : 0u;")],
                   False),
    "blocks": (HERE / "wedge_blocks.cu", [], True),
    "first design": (_FIRST, [], True),
    "first design, loads only (b)": (_FIRST, [(_COMPARE, _LOADS_ONLY)],
                                     False),
    "lookup": (HERE / "wedge_lookup.cu", [], True),
    "merge": (HERE / "wedge_merge.cu", [], True),
    "match": (HERE / "wedge_match.cu", [], True),
}


def sass_counts(lib: Path) -> str:
    """Instruction counts by opcode of a library's D = 16 kernels (their
    mangled names hold the template argument 16), from ``cuobjdump``."""
    from repro_torch import kernels

    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for name, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |$)",
                                 text, flags=re.S):
        if "Li16E" not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                body))
        out.append(f"{name[:60]}: {sum(ops.values())} instructions, " + " ".join(
            f"{k}={v}" for k, v in ops.most_common(12)))
    return "\n  ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", action="store_true")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("wedge_intersect_variants: no CUDA device is visible")
    import chip_smoke as C
    from repro_torch import kernels
    from repro_torch.core import distributed as D
    from repro_torch.core import rules as R
    from repro_torch.kernels.wedge_intersect import kernel as WK
    from repro_torch.kernels.wedge_intersect.ref import (
        common_neighbor_stats_ref,
    )
    from repro_torch.launch import mwis_run

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

    out_dir = kernels.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (tag, (source, edits, _)) in enumerate(VARIANTS.items()):
        if source is None and not edits:
            libs[tag] = WK.LIBS["wedge_intersect"]
            continue
        source = source or WK.LIBS["wedge_intersect"][1][0]
        text = source.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"wedge_intersect_variants: {tag}: the edited text "
                         f"is not once in {source}")
            text = text.replace(old, new)
        path = out_dir / f"wedge_v{i}.cu"
        path.write_text(text)
        libs[tag] = (f"wedge_v{i}", (path,))
    t0 = time.time()
    paths = kernels.build_many(list(libs.values()))
    print(f"built {len(libs)} variants in {time.time() - t0:.1f}s", flush=True)
    fns, counters = {}, {}
    for (tag, lib), path in zip(libs.items(), paths):
        so = kernels.load(*lib)
        if hasattr(so, "wedge_unsorted_edges"):  # a branch on the order
            counters[tag] = so.wedge_unsorted_edges
            counters[tag].restype = ctypes.c_ulonglong
        fn = so.wedge_intersect_launch
        fn.argtypes = WK.ARGTYPES
        fn.restype = ctypes.c_int
        fns[tag] = fn
        if opts.sass:
            print(f"sass {tag}: {sass_counts(path)}", flush=True)

    base = mwis_run.build_parser().parse_args([
        "--family", "rgg", "--n", str(opts.n), "--p", str(opts.p),
        "--mode", "async", "--backend", "torch", "--device", "cuda",
        "--seed", str(opts.seed),
    ])
    t0 = time.time()
    _, pg = mwis_run.prepare(base)
    cfg = D.DisReduConfig(heavy_k=base.heavy_k, mode=base.mode,
                          schedule="cheap-fused", backend="torch")
    prob = D.build_union_problem(pg, cfg.backend, cfg.r_blk, "cuda")
    final, rounds = D.disredu_union(prob, cfg)
    aux = prob.aux
    print(f"instance: RGG n={opts.n} p={opts.p} E={aux.row.shape[0]} "
          f"V={aux.window.shape[0]} D={aux.window.shape[1]} "
          f"({rounds} rounds; {time.time() - t0:.1f}s)", flush=True)
    init = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
    window, row, col = aux.window, aux.row, aux.col
    n_edges, d = row.shape[0], window.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    out_c = torch.empty(n_edges, dtype=torch.int32, device=window.device)
    out_k = torch.empty_like(out_c)
    order = list(fns) + list(fns)[::-1]
    for label, st in (("initial", init), ("final", final)):
        active = (st.status == R.UNDECIDED).contiguous()
        for inp, cols in (("col", col), ("col := row (a)", row)):
            want = common_neighbor_stats_ref(window, st.w, active, row, cols)
            args = (window.data_ptr(), st.w.data_ptr(), active.data_ptr(),
                    row.data_ptr(), cols.data_ptr(), out_c.data_ptr(),
                    out_k.data_ptr(), n_edges, d, 1, stream)
            times = {tag: [] for tag in fns}
            all_pairs = {}
            for tag in order:
                fn = fns[tag]
                out_c.fill_(-1)
                out_k.fill_(-1)
                if tag in counters:
                    counters[tag]()
                rc = fn(*args)
                torch.cuda.synchronize()
                if tag in counters:
                    all_pairs[tag] = counters[tag]()
                if rc != 0 or (VARIANTS[tag][2] and not (
                        torch.equal(out_c, want[0])
                        and torch.equal(out_k, want[1]))):
                    sys.exit(f"wedge_intersect_variants: {tag} (rc {rc}) "
                             f"differs from the plain version ({label}, "
                             f"{inp})")
                times[tag].append(C.cuda_ms(lambda: fn(*args), opts.reps))
            print(f"{label} state, {inp}: " + " | ".join(
                f"{tag} {t[0]:.5f}, {t[1]:.5f} ms"
                for tag, t in times.items())
                + " | edges on the all-pairs path: " + ", ".join(
                    f"{tag} {n}" for tag, n in all_pairs.items()),
                flush=True)


if __name__ == "__main__":
    main()
