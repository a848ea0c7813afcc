#!/usr/bin/env python3
"""Serve one stream with the chunk pipeline on and off, in turns, on one card.

    python3 tools/serve_pipeline_ab.py [--pairs 6] [--algo rg]

Two services of ``repro_torch.core.serve`` on the ``cuda`` backend, the
same but for ``pipeline`` (the default, on, and off), each warmed by one
pass over ``launch.serve``'s stream (192 requests over serve_xs / serve_s
/ serve_m, 4 a topology, batches of 64: three chunks a batch), then timed
pass after pass (``measure_throughput`` with no warm-up) in the order on,
off, off, on, ... for ``--pairs`` pairs.  Prints the card, each pass's
inst/s and p50 / p99 batch latency, the medians of each side, how many
pairs the pipeline won, each service's stage medians and overlap ratio,
and the device busy share of one warm batch of 64 under
``torch.profiler``, on, off, off, on.  Fails unless both services give
every request the same members and weight, every chunk of the pipelined
service is pipelined and none is retried; exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--algo", default="rg", choices=("greedy", "rg", "rnp"))
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("serve_pipeline_ab: no CUDA device is visible")
    import chip_smoke as C
    from repro_torch.core import serve as SV
    from repro_torch.launch.serve import make_requests

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

    svcs = {side: SV.MWISService(SV.ServeConfig(
        algo=opts.algo, backend="cuda", max_batch=64,
        pipeline=side == "on")) for side in ("on", "off")}
    reqs = make_requests(svcs["on"].cells, opts.requests, 4, opts.seed)
    batches = [reqs[i:i + 64] for i in range(0, len(reqs), 64)]
    results = {}
    for side, svc in svcs.items():
        results[side] = [r for b in batches for r in svc.solve_batch(b)]
    for i, (a, b) in enumerate(zip(results["on"], results["off"])):
        if not (a.ok and b.ok and a.weight == b.weight
                and np.array_equal(a.members, b.members)):
            sys.exit(f"serve_pipeline_ab: on and off disagree on request {i}")
    print(f"pipeline on == off: all {len(reqs)} requests, members and "
          f"weight", flush=True)

    runs = {"on": [], "off": []}
    for k in range(opts.pairs):
        for side in (("on", "off") if k % 2 == 0 else ("off", "on")):
            torch.cuda.synchronize()
            tp = SV.measure_throughput(svcs[side], batches, warmup=0)
            runs[side].append(tp)
            print(f"pair {k} {side}: inst_per_s={tp['instances_per_sec']} "
                  f"p50_ms={tp['p50_ms']} p99_ms={tp['p99_ms']}", flush=True)
    med = {side: float(np.median([t["instances_per_sec"] for t in ts]))
           for side, ts in runs.items()}
    wins = sum(a["instances_per_sec"] > b["instances_per_sec"]
               for a, b in zip(runs["on"], runs["off"]))
    print(f"median inst_per_s: on={med['on']} off={med['off']} "
          f"on/off={med['on'] / med['off']:.4f}; the pipeline won "
          f"{wins} of {opts.pairs} pairs", flush=True)
    for side, ts in runs.items():
        print(f"median p50_ms {side}: "
              f"{float(np.median([t['p50_ms'] for t in ts]))}", flush=True)
    for side, svc in svcs.items():
        st = svc.stats
        if side == "on" and not (st["pipelined_chunks"] == st["chunks"]
                                 and st["pipeline_retries"] == 0):
            sys.exit(f"serve_pipeline_ab: pipelined {st['pipelined_chunks']}"
                     f" of {st['chunks']} chunks, "
                     f"{st['pipeline_retries']} retried")
        print(f"{side}: chunks={st['chunks']} "
              f"pipelined={st['pipelined_chunks']} "
              f"stage_p50_ms={st['stage_p50_ms']} "
              f"overlap_ratio={st['overlap_ratio']}", flush=True)
    for side in ("on", "off", "off", "on"):
        svc = svcs[side]
        C.device_profile(f"pipeline {side}, one warm batch of 64",
                         lambda: svc.solve_batch(batches[0]), top=0)
    for svc in svcs.values():
        svc.close()


if __name__ == "__main__":
    main()
