#!/usr/bin/env python3
"""Time the reduction rules' scatters in two forms.

    python3 tools/scatter_forms.py [--n 1048576] [--rnp-n 65536]

The rules (``src/repro_torch/core/rules.py``) scatter only their firing
lanes, compacted by ``nonzero``: one host sync per scatter.  The other form
needs no sync: every lane scatters, each lane that does not fire onto a
slot of its own past the end of a copy of the target, which is sliced off
afterwards.  Only that form leaves a sweep free of host syncs, as a CUDA
graph over a sweep would need.  The script runs reduce/cheap-fused on RGG
``--n`` (DisReduA, p = 4, ``cuda`` backend, the union problem built once)
in turns compact, spread, spread, compact, then rnp/edges-only on RGG
``--rnp-n`` once in each form, and prints each run's host-clock seconds
of ``solvers.solve_union`` (the union build and one untimed warm-up reduce
run excluded).  It fails unless both forms give the same final state,
trip count and members.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FIELDS = ("w", "status", "log_kind", "log_v", "log_u", "log_n", "offset")


def spread_form() -> dict:
    """``rules``' ``_lanes`` / ``_set_at`` / ``_add_at`` / ``_amax_at``
    without the compaction: the mask itself is the lanes."""
    import torch

    def flat(val, mask, dtype):
        if not torch.is_tensor(val):
            return torch.full((mask.numel(),), val, dtype=dtype,
                              device=mask.device)
        return val.expand(mask.shape).reshape(-1).to(dtype)

    def spread(dst, mask, idx):
        n = dst.shape[0]
        ext = torch.cat([dst, dst.new_empty(mask.numel())])
        tail = torch.arange(n, n + mask.numel(), device=dst.device)
        return ext, torch.where(mask.reshape(-1), idx.reshape(-1).long(),
                                tail)

    def set_at(dst, mask, idx, val):
        ext, i = spread(dst, mask, idx)
        ext[i] = flat(val, mask, dst.dtype)
        return ext[:dst.shape[0]].clone()

    def add_at(dst, mask, idx, val):
        ext, i = spread(dst, mask, idx)
        ext.index_add_(0, i, flat(val, mask, dst.dtype))
        return ext[:dst.shape[0]].clone()

    def amax_at(dst, mask, idx, val):
        ext, i = spread(dst, mask, idx)
        ext.scatter_reduce_(0, i, flat(val, mask, dst.dtype), "amax",
                            include_self=True)
        return ext[:dst.shape[0]].clone()

    return dict(_lanes=lambda mask: mask, _set_at=set_at, _add_at=add_at,
                _amax_at=amax_at)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--rnp-n", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()

    import torch

    from repro_torch import kernels
    from repro_torch.core import distributed as D
    from repro_torch.core import rules as R
    from repro_torch.core import solvers as S
    from repro_torch.kernels.segment_coo import kernel as K
    from repro_torch.launch import mwis_run

    if opts.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("scatter_forms: no CUDA device is visible")
        kernels.build_many([K.LIBS["segment_fused"]])

    def sync():
        if opts.device == "cuda":
            torch.cuda.synchronize()

    compact = {k: getattr(R, k) for k in ("_lanes", "_set_at", "_add_at",
                                          "_amax_at")}
    forms = {"compact": compact, "spread": spread_form()}

    def turns(n, algo, schedule, order, warm_up):
        args = mwis_run.build_parser().parse_args([
            "--family", "rgg", "--n", str(n), "--p", "4", "--mode", "async",
            "--backend", "cuda", "--device", opts.device,
            "--seed", str(opts.seed)])
        _, pg = mwis_run.prepare(args)
        cfg = D.DisReduConfig(heavy_k=args.heavy_k, mode=args.mode,
                              schedule=schedule, backend=args.backend)
        prob = D.build_union_problem(pg, cfg.backend, cfg.r_blk, opts.device)
        if warm_up:
            S.solve_union(prob, algo, cfg)
        want, seconds = None, {name: [] for name in forms}
        for name in order:
            for k, fn in forms[name].items():
                setattr(R, k, fn)
            try:
                sync()
                t0 = time.time()
                state, members, rounds = S.solve_union(prob, algo, cfg)
                sync()
                seconds[name].append(time.time() - t0)
            finally:
                for k, fn in compact.items():
                    setattr(R, k, fn)
            got = [rounds, members.cpu()] + [getattr(state, f).cpu()
                                             for f in FIELDS]
            if want is None:
                want = got
            elif got[0] != want[0] or not all(
                    torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
                sys.exit(f"scatter_forms: the {name} form changed "
                         f"{algo} at n={n}")
            print(f"{algo}/{schedule} n={n} {name}: trips={rounds} "
                  f"seconds={seconds[name][-1]:.3f}", flush=True)
        print(f"{algo}/{schedule} n={n}: all {len(order)} runs identical; "
              + ", ".join(f"{k} {min(v):.3f}-{max(v):.3f} s"
                          for k, v in seconds.items()), flush=True)

    turns(opts.n, "reduce", "cheap-fused",
          ("compact", "spread", "spread", "compact"), True)
    turns(opts.rnp_n, "rnp", "edges-only", ("compact", "spread"), False)


if __name__ == "__main__":
    main()
