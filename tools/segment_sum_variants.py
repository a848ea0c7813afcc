#!/usr/bin/env python3
"""Time source variants of the ``segment_sum`` CUDA kernel on one card.

    python3 tools/segment_sum_variants.py [--reps 50]

Each variant is ``src/repro_torch/kernels/segment_coo/csrc/segment_sum.cu``
with one constant changed: ``kUnroll`` (the payload loads a lane keeps in
flight) or ``kMaxWarps`` (the warps a block holds).  The variants are built
with one ``nvcc`` each, all started together, and launched through the C
interface, as the wrapper launches the committed source, on the instances
of ``chip_smoke.py``'s segment_sum phase: graphsage-reddit
``minibatch_lg``'s sampled subgraph at r_blk 8, D 602 and 128, float32 and
bfloat16.  Every variant must give the committed kernel's bits.  Prints the
card, then each instance's mean CUDA-event time per variant, timed in the
order given and again in reverse; exits non-zero on any failure or without
a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: tag -> (the committed line, its replacement); None is the committed source
VARIANTS = {
    "kUnroll 8 (committed)": None,
    "kUnroll 4": ("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;"),
    "kUnroll 16": ("constexpr int kUnroll = 8;",
                   "constexpr int kUnroll = 16;"),
    "kMaxWarps 4": ("constexpr int kMaxWarps = 8;",
                    "constexpr int kMaxWarps = 4;"),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()

    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("segment_sum_variants: no CUDA device is visible")
    import chip_smoke as C
    from repro_torch import kernels
    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.kernels.segment_coo.ops import pack_blocks

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

    source = K.LIBS["segment_sum"][1][0]
    text = source.read_text()
    out_dir = kernels.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (tag, edit) in enumerate(VARIANTS.items()):
        if edit is None:
            libs[tag] = K.LIBS["segment_sum"]
            continue
        if text.count(edit[0]) != 1:
            sys.exit(f"segment_sum_variants: {edit[0]!r} is not in {source}")
        path = out_dir / f"segment_sum_v{i}.cu"
        path.write_text(text.replace(*edit))
        libs[tag] = (f"segment_sum_v{i}", (path,))
    kernels.build_many(list(libs.values()))
    fns = {}
    for tag, lib in libs.items():
        fn = kernels.load(*lib).segment_sum_launch
        fn.argtypes = K._ARGTYPES["segment_sum"]
        fn.restype = ctypes.c_int
        fns[tag] = fn

    size = C.SEGMENT_SUM_SIZE
    dev = torch.device("cuda")
    row = C.sampled_targets(size["seeds"], size["fanouts"])
    perm, lrow, e_blk = pack_blocks(row, size["n_rows"], r_blk=size["r_blk"])
    perm = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lrow = torch.from_numpy(lrow).to(dev)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(fns) + list(fns)[::-1]
    for d in size["widths"]:
        x32 = torch.randn((row.shape[0], d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            data = x32.to(dtype)
            want = K.segment_sum(data, perm, lrow, size["n_rows"],
                                 r_blk=size["r_blk"])
            out = torch.empty_like(want)
            args = (perm.data_ptr(), lrow.data_ptr(), data.data_ptr(),
                    out.data_ptr(), perm.shape[0], e_blk, size["r_blk"],
                    size["n_rows"], d, K._SUM_DTYPES[dtype], K._sum_vec(data),
                    stream)
            times = {tag: [] for tag in fns}
            for tag in order:
                fn = fns[tag]
                out.fill_(float("nan"))
                rc = fn(*args)
                torch.cuda.synchronize()
                if rc != 0 or not torch.equal(out, want):
                    sys.exit(f"segment_sum_variants: {tag} (rc {rc}) differs "
                             f"from the committed kernel at D {d} {dtype}")
                times[tag].append(C.cuda_ms(lambda: fn(*args), opts.reps))
            print(f"D={d} {str(dtype)[6:]} vec={K._sum_vec(data)}: " + " | ".join(
                f"{tag} {t[0]:.5f}, {t[1]:.5f} ms" for tag, t in times.items()),
                flush=True)


if __name__ == "__main__":
    main()
