#!/usr/bin/env python3
"""Time source variants of the ``embedding_bag`` CUDA kernels on one card.

    python3 tools/embedding_bag_variants.py [--reps 50]
    python3 tools/embedding_bag_variants.py --backward [--reps 50] [--ptxas]

The forward's instances are ``chip_smoke.py``'s: dlrm-mlperf's largest
table (39,979,771 x 128) at ``serve_bulk`` B = 262,144, K = 1 and 4, float32
and then bfloat16, uniform indices from the seed.  The variants are the
committed ``src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu``,
the same with its constants changed (``kSingleHotBags`` and
``kBagsPerGroup``: the bags a narrow lane group takes at once at K = 1 and
above; ``kUnroll``: the lookups of a bag loaded together when K > 1;
``kWarps``: the warps a block holds), and the first design
(``tools/variants/embedding_bag_first.cu``: a warp a bag, narrow rows split
over lane groups by lookup and summed by shuffles).

``--backward`` times the backward (``embedding_bag_bwd_launch``, float32,
D 128) instead, on ``chip_smoke.py``'s cases in this order: the 3-row
table (hot rows) and the capped 2,000,384-row table (ids in [0, 2,000,000))
at dlrm-mlperf's ``train_batch`` B 65,536, K 1 (phase 20); the largest
table at B 262,144, K 1 and 4 on uniform ids, and K 1 on Zipf ids (a 1.05,
``chip_smoke.zipf_ids``) (phase 13).  The variants are the committed
source, the same with ``kBwdTile`` (lookups a block), ``kBwdStage`` (rows
a tile stages in shared memory) or ``kBwdUnroll`` (lookups a lane group
loads ahead) changed, a losing design (``tools/variants/
embedding_bag_bwd_sorted.cu``: the tile counting-sorted by row, runs of
one row summed in registers, no shared-memory float atomics) and the
first design (``tools/variants/embedding_bag_bwd_first.cu``: one thread a
bag and column vector, one global vector atomic a lookup, nothing
combined).  Each case also times
``index_add_`` of the weighted rows (made before the window) into the same
buffer, and prints the bound (``chip_smoke.time_embedding_bag_bwd``'s
bytes).  ``--ptxas`` first prints each backward variant's registers,
spills and shared memory, and the atomic instructions of the committed
library (``cuobjdump -sass``).

All variants are built with one ``nvcc`` each, all started together,
launched through the C interface as the wrapper launches the committed
source, and held against the plain version at ``chip_smoke.py``'s
tolerance (``check_embedding_bag`` / ``check_embedding_bag_bwd``).  Prints
the card, then each instance's mean CUDA-event time per variant, timed in
the order given and again in reverse; exits non-zero on any failure or
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

_COMMITTED = {"kSingleHotBags": 4, "kBagsPerGroup": 2, "kUnroll": 2,
              "kWarps": 4}


def _set(**values: int) -> list[tuple[str, str]]:
    """Edits of the committed source that set these constants."""
    return [(f"constexpr int {k} = {_COMMITTED[k]};",
             f"constexpr int {k} = {v};") for k, v in values.items()]


#: tag -> (source or None for the committed one, [(its text, replacement)])
VARIANTS = {
    "committed": (None, []),
    "single-hot bags 2": (None, _set(kSingleHotBags=2)),
    "bags 1 unroll 4": (None, _set(kBagsPerGroup=1, kUnroll=4)),
    "warps 8": (None, _set(kWarps=8)),
    "first design": (Path(__file__).resolve().parent / "variants"
                     / "embedding_bag_first.cu", []),
}

_BWD_COMMITTED = {"kBwdTile": 128, "kBwdStage": 32, "kBwdUnroll": 4}


def _set_bwd(**values: int) -> list[tuple[str, str]]:
    """Edits of the committed source that set the backward's constants."""
    return [(f"constexpr int {k} = {_BWD_COMMITTED[k]};",
             f"constexpr int {k} = {v};") for k, v in values.items()]


_SORTED = Path(__file__).resolve().parent / "variants" \
    / "embedding_bag_bwd_sorted.cu"
_FIRST = Path(__file__).resolve().parent / "variants" \
    / "embedding_bag_bwd_first.cu"
#: The backward's variants, as ``VARIANTS``.
BWD_VARIANTS = {
    "committed": (None, []),
    "tile 64": (None, _set_bwd(kBwdTile=64)),
    "tile 256": (None, _set_bwd(kBwdTile=256)),
    "stage 16": (None, _set_bwd(kBwdStage=16)),
    "stage 64": (None, _set_bwd(kBwdStage=64)),
    "unroll 2": (None, _set_bwd(kBwdUnroll=2)),
    "unroll 8": (None, _set_bwd(kBwdUnroll=8)),
    "sorted design": (_SORTED, []),
    "first design": (_FIRST, []),
}


def build(variants: dict, entry: str, prefix: str) -> tuple[dict, dict]:
    """Write, build and load every variant; returns tag -> its ``entry``
    (argtypes set) and tag -> (library name, sources)."""
    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag import kernel as EK

    committed = EK.LIBS["embedding_bag"][1][0]
    out_dir = kernels.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (tag, (source, edits)) in enumerate(variants.items()):
        if source is None and not edits:
            libs[tag] = EK.LIBS["embedding_bag"]
            continue
        text = (source or committed).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"embedding_bag_variants: {old!r} is not once in "
                         f"{source or committed}")
            text = text.replace(old, new)
        path = out_dir / f"{prefix}{i}.cu"
        path.write_text(text)
        libs[tag] = (f"{prefix}{i}", (path,))
    kernels.build_many(list(libs.values()))
    fns = {}
    for tag, lib in libs.items():
        fn = getattr(kernels.load(*lib), entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns, libs


def ptxas(libs: dict) -> None:
    """Each variant's registers, spills and shared memory (``nvcc -Xptxas
    -v``), then the committed library's shared-memory atomics (SASS)."""
    from repro_torch import kernels

    for tag, (_, (path,)) in libs.items():
        res = subprocess.run(
            [kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", "/dev/null",
             str(path)], capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"embedding_bag_variants: nvcc failed for {tag}:\n"
                     f"{res.stderr}")
        fn, used = "", []
        for ln in res.stderr.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
            elif "embedding_bag_bwdI" in fn and ("Used" in ln
                                                 or "spill" in ln):
                name = fn[fn.index("embedding_bag_bwdI"):][:28]
                used.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
        print(f"ptxas {tag}: {' | '.join(used)}", flush=True)
    lib = kernels.library_path(*libs["committed"])
    sass = subprocess.run(
        [str(Path(kernels.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True)
    ops = sorted({tok for ln in sass.stdout.splitlines()
                  for tok in ln.split(";")[0].split()
                  if tok.startswith(("ATOM", "RED"))})
    print(f"sass atomics of the committed library: {ops or sass.stderr}",
          flush=True)


def forward(opts, C, fns) -> None:
    import torch

    from repro_torch.kernels.embedding_bag import kernel as EK

    size = C.EMBEDDING_BAG_SIZE
    V, D, B = (size[k] for k in "VDB")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(fns) + list(fns)[::-1]
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((V, D), generator=gen, device=dev, dtype=dtype)
        for k_bag in size["bags"]:
            idx = torch.randint(0, V, (B, k_bag), generator=gen, device=dev,
                                dtype=torch.int32)
            wgt = torch.randn((B, k_bag), generator=gen, device=dev)
            out = torch.empty((B, D), dtype=dtype, device=dev)
            args = (table.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                    out.data_ptr(), B, k_bag, D, V, EK._DTYPES[dtype], 1,
                    stream)
            tag_of = f"K={k_bag} {str(dtype)[6:]}"
            times = {tag: [] for tag in fns}
            for tag in order:
                fn = fns[tag]
                out.fill_(float("nan"))
                rc = fn(*args)
                torch.cuda.synchronize()
                if rc != 0:
                    sys.exit(f"embedding_bag_variants: {tag} failed ({rc})")
                C.check_embedding_bag(out, table, idx, wgt,
                                      f"{tag_of} {tag}")
                times[tag].append(C.cuda_ms(lambda: fn(*args), opts.reps))
            print(f"{tag_of}: " + " | ".join(
                f"{tag} {t[0]:.5f}, {t[1]:.5f} ms"
                for tag, t in times.items()), flush=True)
        del table
        torch.cuda.empty_cache()


def backward(opts, C, fns) -> None:
    import torch

    from repro_torch.kernels.embedding_bag.ref import live_rows

    size = C.EMBEDDING_BAG_SIZE
    V, D, B = (size[k] for k in "VDB")
    b_train = C.DLRM_TRAIN["batch"]
    cap = C.DLRM_TRAIN["row_cap"]
    cap_rows = (cap + 511) // 512 * 512  # the capped table's padded rows
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(fns) + list(fns)[::-1]

    def uniform(n_ids, b, k):
        return torch.randint(0, n_ids, (b, k), generator=gen, device=dev,
                             dtype=torch.int32)

    cases = [  # label, n_rows, ids
        (f"3-row table B={b_train} K=1", 3, lambda: uniform(3, b_train, 1)),
        (f"capped table ({cap_rows} rows) B={b_train} K=1", cap_rows,
         lambda: uniform(cap, b_train, 1)),
        (f"phase 13 V={V} B={B} K=1", V, lambda: uniform(V, B, 1)),
        (f"phase 13 V={V} B={B} K=4", V, lambda: uniform(V, B, 4)),
        (f"Zipf a=1.05 V={V} B={B} K=1", V, lambda: torch.from_numpy(
            C.zipf_ids((B, 1), V, 1.05, opts.seed)).to(dev)),
    ]
    for label, n_rows, ids in cases:
        idx = ids()
        b, k_bag = idx.shape
        wgt = torch.randn((b, k_bag), generator=gen, device=dev)
        cot = torch.randn((b, D), generator=gen, device=dev)
        buf = torch.zeros((n_rows, D), device=dev)
        args = (cot.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                buf.data_ptr(), b, k_bag, D, n_rows, 0, 1, stream)
        times = {tag: [] for tag in fns}
        for tag in order:
            fn = fns[tag]
            buf.zero_()
            rc = fn(*args)
            torch.cuda.synchronize()
            if rc != 0:
                sys.exit(f"embedding_bag_variants: {tag} failed ({rc})")
            C.check_embedding_bag_bwd(buf, cot, idx, wgt, n_rows,
                                      f"{label} {tag}")
            times[tag].append(C.cuda_ms(lambda: fn(*args), opts.reps))
        rows, live = live_rows(idx, n_rows)
        rows_l = rows[live]
        weighted = (cot[:, None, :] * wgt[..., None])[live]
        touched = int(torch.unique(rows_l).shape[0])
        lib = [C.cuda_ms(lambda: buf.index_add_(0, rows_l, weighted),
                         opts.reps) for _ in range(2)]
        bound, _ = C.bound(cot.numel() * 4 + idx.numel() * 8
                           + 2 * touched * D * 4, int(live.sum()) * D,
                           "fp32_fma")
        print(f"{label}: bound {bound:.5f} ms (bytes; {touched} touched "
              f"rows) | index_add_ {lib[0]:.5f}, {lib[1]:.5f} ms | " +
              " | ".join(f"{tag} {t[0]:.5f}, {t[1]:.5f} ms "
                         f"({bound / min(t):.4f} of bound)"
                         for tag, t in times.items()), flush=True)
        del buf, weighted
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backward", action="store_true",
                    help="time the backward's variants")
    ap.add_argument("--ptxas", action="store_true",
                    help="with --backward: print registers and the SASS "
                         "atomics first")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("embedding_bag_variants: no CUDA device is visible")
    import chip_smoke as C

    def smi(query: str, fmt: str = "csv,noheader") -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    print(smi("name,power.limit"), flush=True)
    C.CARD.update(sms=torch.cuda.get_device_properties(0)
                  .multi_processor_count,
                  max_sm_hz=float(smi("clocks.max.sm",
                                      "csv,noheader,nounits")) * 1e6)
    if opts.backward:
        fns, libs = build(BWD_VARIANTS, "embedding_bag_bwd_launch",
                          "embedding_bag_bwd_v")
        if opts.ptxas:
            ptxas(libs)
        backward(opts, C, fns)
    else:
        forward(opts, C, build(VARIANTS, "embedding_bag_launch",
                               "embedding_bag_v")[0])

if __name__ == "__main__":
    main()
