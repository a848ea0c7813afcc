#!/usr/bin/env python3
"""Time source variants of the ``embedding_bag`` CUDA kernel on one card.

    python3 tools/embedding_bag_variants.py [--reps 50]

The instances are ``chip_smoke.py``'s: dlrm-mlperf's largest table
(39,979,771 x 128) at ``serve_bulk`` B = 262,144, K = 1 and 4, float32
and then bfloat16, uniform indices from the seed.  The variants are the
committed ``src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu``,
the same with its constants changed (``kSingleHotBags`` and
``kBagsPerGroup``: the bags a narrow lane group takes at once at K = 1 and
above; ``kUnroll``: the lookups of a bag loaded together when K > 1;
``kWarps``: the warps a block holds), and the first design
(``tools/variants/embedding_bag_first.cu``: a warp a bag, narrow rows split
over lane groups by lookup and summed by shuffles).  All are built with one
``nvcc`` each, all started together, launched through the C interface as
the wrapper launches the committed source, and held against the plain
version at ``chip_smoke.py``'s tolerance.  Prints the card, then each
instance's mean CUDA-event time per variant, timed in the order given and
again in reverse; exits non-zero on any failure or without a CUDA device.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("embedding_bag_variants: no CUDA device is visible")
    import chip_smoke as C
    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag import kernel as EK

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

    committed = EK.LIBS["embedding_bag"][1][0]
    out_dir = kernels.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (tag, (source, edits)) in enumerate(VARIANTS.items()):
        if source is None and not edits:
            libs[tag] = EK.LIBS["embedding_bag"]
            continue
        text = (source or committed).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"embedding_bag_variants: {old!r} is not once in "
                         f"{source or committed}")
            text = text.replace(old, new)
        path = out_dir / f"embedding_bag_v{i}.cu"
        path.write_text(text)
        libs[tag] = (f"embedding_bag_v{i}", (path,))
    kernels.build_many(list(libs.values()))
    fns = {}
    for tag, lib in libs.items():
        fn = kernels.load(*lib).embedding_bag_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tag] = fn

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


if __name__ == "__main__":
    main()
