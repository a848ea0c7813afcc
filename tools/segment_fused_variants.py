#!/usr/bin/env python3
"""Time designs of the ``segment_fused`` CUDA kernel on one card.

    python3 tools/segment_fused_variants.py [--n 1048576] [--rnp-n 65536]
                                            [--reps 50] [--ptxas]

The inputs are ``chip_smoke.py``'s:

  * ``full``: the union plan of RGG n = 2^20, p = 4 (phase 6) with the
    cheap-fused columns (S/deg, M/only, wbits/wnh) of the reduce run's
    final state;
  * ``serve_xs`` / ``serve_s`` / ``serve_m``: each cell's real stacked
    chunk of 64 requests of the serving stream (phase 14), first-sweep
    columns;
  * ``rnp``: the union plan of RGG n = 2^16, p = 4 (phase 9) with the
    edges-only columns (S/deg, M/only) of its initial state.

The variants, each built with one ``nvcc``, all started together, and
launched through its C interface as the wrapper launches the committed
source:

  * ``first``: the first design (``tools/variants/segment_fused_first.cu``:
    one thread block a row block, sweeping all E_BLK slots, one shared
    atomic a live slot and column);
  * ``match``: the first redesign (``tools/variants/segment_fused_match.cu``:
    live extents and splits, but each row's lanes folded by
    ``__match_any_sync`` and ``__reduce_*_sync`` over the row's own mask,
    4 slots a thread in flight);
  * ``scan``: the second (``tools/variants/segment_fused_scan.cu``: every
    run of neighbouring lanes of one row folded by a segmented shuffle
    scan, 2 slots a thread in flight, no prefetch);
  * ``merge``: the committed design with its first heavy-block combine
    (``tools/variants/segment_fused_merge.cu``: the thread blocks of a
    split row block write partials to scratch, count themselves done, and
    the last folds them);
  * ``extent``: the committed source without the warp folds (every live
    slot its own atomic) and without splits: stops at the live extent
    only;
  * ``fold``: the committed source reading every slot up to E_BLK (the
    extent ignored), without splits: folds warps of one row only;
  * ``extent+fold``: the committed source without splits;
  * ``committed``: extent, folds, and row blocks over kChunk live slots
    split over thread blocks, which combine into identity-filled rows with
    global atomics;
  * the committed source with kChunk or kThreads changed.

Every variant must give the committed kernel's bits, and the committed
kernel the plain version's.  Each is timed by replaying a CUDA graph of
``--reps`` launches (the card's time, without the host's launch cost), in
the order given and again in reverse.  Per input the tool prints the card,
the plan, each variant's two times, and what the padding sweep and the
same-row atomics cost: ``fold`` minus ``extent+fold`` and ``extent`` minus
``extent+fold``.  ``--ptxas`` first prints each variant's registers and
spills (``nvcc -Xptxas -v``).  Exits non-zero on any failure or without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
HERE = Path(__file__).resolve().parent / "variants"

_NO_FOLD = ("const bool one_row = __all_sync(kWarp, lane == 0 || up == r);",
            "const bool one_row = false;")
_NO_EXTENT = ("const int end = live_end(extent, slab, e_blk);",
              "const int end = e_blk;")
_NO_SPLIT = ("constexpr int kChunk = 1024;", "constexpr int kChunk = 1 << 30;")


def _const(name: str, old: int, new: int) -> tuple[str, str]:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


#: tag -> (source (None: the committed one), [(its text, the replacement)])
VARIANTS = {
    "first": (HERE / "segment_fused_first.cu", []),
    "match": (HERE / "segment_fused_match.cu", []),
    "scan": (HERE / "segment_fused_scan.cu", []),
    "merge": (HERE / "segment_fused_merge.cu", []),
    "extent": (None, [_NO_FOLD, _NO_SPLIT]),
    "fold": (None, [_NO_EXTENT, _NO_SPLIT]),
    "extent+fold": (None, [_NO_SPLIT]),
    "committed": (None, []),
    "kChunk 2048": (None, [_const("kChunk", 1024, 2048)]),
    "kChunk 4096": (None, [_const("kChunk", 1024, 4096)]),
    "kChunk 512": (None, [_const("kChunk", 1024, 512)]),
    "kThreads 128": (None, [_const("kThreads", 256, 128)]),
    "kThreads 128, kChunk 512": (None, [_const("kThreads", 256, 128),
                                        _const("kChunk", 1024, 512)]),
}


def build(K, kernels, ptxas: bool) -> dict:
    """Write, build and load every variant; returns tag -> (launch, its
    interface: "first" (no extent), "scratch" (a scratch pointer sized by
    the source's ``segment_fused_scratch``; returned beside it) or
    "committed").  With ``ptxas``, prints each variant's registers and
    spills first."""
    committed = K.LIBS["segment_fused"][1][0]
    text = committed.read_text()
    out_dir = kernels.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (tag, (source, edits)) in enumerate(VARIANTS.items()):
        if source is None and not edits:
            libs[tag] = K.LIBS["segment_fused"]
            continue
        src = source.read_text() if source else text
        for old, new in edits:
            if src.count(old) != 1:
                sys.exit(f"segment_fused_variants: {old!r} is not once in "
                         f"the source of {tag}")
            src = src.replace(old, new)
        path = out_dir / f"segment_fused_v{i}.cu"
        path.write_text(src)
        libs[tag] = (f"segment_fused_v{i}", (path,))
    for tag, (_, (path,)) in libs.items() if ptxas else ():
        res = subprocess.run(
            [kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", "/dev/null",
             str(path)], capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"segment_fused_variants: nvcc failed for {tag}:\n"
                     f"{res.stderr}")
        used = [ln.split(":", 1)[-1].strip() for ln in res.stderr.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"ptxas {tag}: {'; '.join(used)}", flush=True)
    kernels.build_many(list(libs.values()))
    fns = {}
    for tag, lib in libs.items():
        so = kernels.load(*lib)
        fn = so.segment_fused_launch
        fn.restype = ctypes.c_int
        if tag == "first":
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 \
                + [ctypes.c_void_p]
            fns[tag] = (fn, "first")
        elif hasattr(so, "segment_fused_scratch"):
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 \
                + [ctypes.c_void_p]
            size = so.segment_fused_scratch
            size.argtypes = [ctypes.c_int] * 6
            size.restype = ctypes.c_longlong
            fns[tag] = (fn, size)
        else:
            fn.argtypes = K._ARGTYPES["segment_fused"]
            fns[tag] = (fn, "committed")
    return fns


def run_input(name: str, prob, kw: dict, fns: dict, reps: int) -> None:
    """Check and time every variant on one input; print its lines."""
    import torch

    import chip_smoke as C
    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.kernels.segment_coo.ops import segment_fused_plain

    plan = prob.plan
    ep, lr = plan.edge_perm, plan.lrow
    batch = ep.shape[0] if ep.dim() == 3 else 1
    n_blocks, e_blk = ep.shape[-2:]
    total = prob.aux.gid.shape[0]
    n_rows = total // batch
    groups = [kw.get(k) for k in ("data_sum", "data_max", "data_min",
                                  "data_or")]
    widths = [0 if d is None else d.shape[1] for d in groups]
    n_edges = next(d.shape[0] for d in groups if d is not None)
    plain_kw = {k: v for k, v in kw.items() if k != "extent"}
    want = K.segment_fused(ep, lr, n_rows, **kw)
    torch.cuda.synchronize()
    if C.max_abs_err(want, segment_fused_plain(ep, lr, n_rows, **plain_kw)):
        sys.exit(f"segment_fused_variants: {name}: the committed kernel != "
                 f"the plain version")
    live = int(((lr >= 0) & (lr < plan.r_blk)).sum())
    cols = sum(widths)
    live_bytes = 4 * (batch * n_blocks + 2 * live + n_edges * cols
                      + total * cols)
    bound_ms, _ = C.bound(live_bytes, live * cols, "int32")
    print(f"{name}: batch={batch} n_blocks={n_blocks} r_blk={plan.r_blk} "
          f"E_BLK={e_blk} slots={batch * n_blocks * e_blk} live={live} "
          f"extent_max={int(plan.extent.max())} widths={widths} "
          f"bound_live_ms={bound_ms:.5f}", flush=True)

    def ptr(t):
        return None if t is None else t.data_ptr()

    calls = {}
    for tag, (fn, kind) in fns.items():
        outs = [None if d is None else torch.empty(
            (total, d.shape[1]), dtype=torch.int32, device=ep.device)
            for d in groups]
        shape = (batch, n_blocks, e_blk, plan.r_blk, n_rows, n_edges // batch,
                 *widths, kw["or_nbits"])
        if kind == "first":
            args = (ep.data_ptr(), lr.data_ptr(), *map(ptr, groups),
                    *map(ptr, outs), *shape)
        elif kind == "committed":
            args = (ep.data_ptr(), lr.data_ptr(), plan.extent.data_ptr(),
                    *map(ptr, groups), *map(ptr, outs), *shape)
        else:
            n = kind(batch, n_blocks, e_blk, plan.r_blk, cols,
                     n_edges // batch)
            scratch = None if n == 0 else torch.empty(
                n, dtype=torch.int32, device=ep.device)
            args = (ep.data_ptr(), lr.data_ptr(), plan.extent.data_ptr(),
                    *map(ptr, groups), *map(ptr, outs), ptr(scratch), *shape)
            outs.append(scratch)  # kept alive with the outputs

        def call(fn=fn, args=args):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"segment_fused_variants: launch failed ({rc})")

        for o in outs[:4]:
            if o is not None:
                o.fill_(0x5A5A5A5A)
        call()
        torch.cuda.synchronize()
        if C.max_abs_err(outs[:4], want):
            sys.exit(f"segment_fused_variants: {name}: {tag} differs from "
                     f"the committed kernel")
        calls[tag] = (call, outs)
    times = {tag: [] for tag in calls}
    for tag in list(calls) + list(calls)[::-1]:
        times[tag].append(C.graph_ms(calls[tag][0], reps))
    print(f"{name}: " + " | ".join(
        f"{tag} {t[0]:.5f}, {t[1]:.5f} ms" for tag, t in times.items()),
        flush=True)
    mean = {tag: sum(t) / 2 for tag, t in times.items()}
    both = mean["extent+fold"]
    print(f"{name}: padding sweep (fold - extent+fold) "
          f"{mean['fold'] - both:.5f} ms; same-row atomics (extent - "
          f"extent+fold) {mean['extent'] - both:.5f} ms; split (extent+fold "
          f"- committed) {both - mean['committed']:.5f} ms; atomic "
          f"combine (merge - committed) "
          f"{mean['merge'] - mean['committed']:.5f} ms; first "
          f"{mean['first']:.5f} ms, committed {mean['committed']:.5f} ms "
          f"({bound_ms / mean['committed']:.4f} of the live bound)",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--rnp-n", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("segment_fused_variants: no CUDA device is visible")
    import chip_smoke as C
    from repro_torch import kernels
    from repro_torch.core import distributed as D
    from repro_torch.core import rules as R
    from repro_torch.core import serve as SV
    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.launch import mwis_run
    from repro_torch.launch.serve import make_requests

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    C.CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    C.CARD["max_sm_hz"] = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    fns = build(K, kernels, opts.ptxas)

    svc = SV.MWISService(SV.ServeConfig(algo="rg", backend="cuda",
                                        max_batch=64, device="cuda"))
    reqs = make_requests(svc.cells, 192, 4, opts.seed)
    for cell in svc.cells:
        prob, kw = C.serve_chunk(svc, reqs, cell.name)
        run_input(cell.name, prob, kw, fns, opts.reps)

    for label, n in (("rnp", opts.rnp_n), ("full", opts.n)):
        args = mwis_run.build_parser().parse_args([
            "--family", "rgg", "--n", str(n), "--p", "4", "--mode", "async",
            "--backend", "cuda", "--device", "cuda", "--seed",
            str(opts.seed)])
        _, pg = mwis_run.prepare(args)
        cfg = D.DisReduConfig(heavy_k=args.heavy_k, mode=args.mode,
                              schedule="cheap-fused", backend="cuda")
        prob = D.build_union_problem(pg, "cuda", cfg.r_blk, "cuda")
        if label == "rnp":
            state = R.init_state(prob.w0, prob.is_local, prob.is_ghost)
            kw = C.fused_args(prob, state, "edges-only")
        else:
            state, _ = D.disredu_union(prob, cfg)
            kw = C.fused_args(prob, state, "cheap-fused")
        run_input(label, prob, kw, fns, opts.reps)
        del prob, state, kw
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
