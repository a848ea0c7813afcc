"""Serving entry point of the port: batched MWIS solving, DLRM scoring, or
LM decode, on the cards.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mwis --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mwis --algo rnp \\
        --backend cuda --batch 16 --repeat-topologies 4 --devices 1 \\
        --no-pipeline
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --tokens 16

The default ``mwis`` arch: a stream of random instances is bucketed into
the static serve cells, topology-cached and solved as stacked batches
(:mod:`repro_torch.core.serve`); it reports sustained
instances/sec, p50/p99 batch latency and plan-cache statistics.  Same
flags and printed lines as ``repro.launch.serve --arch mwis`` —
``--devices`` (serve-mesh size; default every visible card, more than
are visible exits 2) and ``--no-pipeline`` (chunks one after another)
included — plus ``--device`` (default cuda; without a visible GPU it
exits unless ``--device cpu`` is given).
``--descent auto`` sends serve_m requests through the staged solver and
admits instances too large for every serve cell through the descent
cells.

``dlrm-mlperf`` scores ``--requests`` batches of ``--batch`` synthetic
requests (``data.pipeline.dlrm_batch``) with the SMOKE config's DLRM,
whose 26 lookups launch the ``embedding_bag`` kernel on the card; the LM
archs decode ``--tokens`` greedy tokens for a batch of ``--batch`` against
a KV cache, with their SMOKE configs — both as the reference's CLI does,
with its printed lines.  ``--seed`` seeds the weights (a
``torch.Generator`` on the device); the DLRM batches take
``DLRMBatchSpec``'s own seed, as the reference's do.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import dlrm_mlperf, gemma3_1b, mistral_nemo_12b
from repro_torch.configs import qwen3_32b
from repro_torch.core import serve as SV
from repro_torch.data.pipeline import DLRMBatchSpec, dlrm_batch
from repro_torch.graphs.generators import gnm
from repro_torch.launch import mesh
from repro_torch.models import common as MC
from repro_torch.models import dlrm as DM
from repro_torch.models import transformer as TM

ARCHES = ("mwis", "dlrm-mlperf", "gemma3-1b", "qwen3-32b",
          "mistral-nemo-12b")

#: The LM archs' decode configs: the SMOKE sizes, as the reference's CLI.
LM_SMOKES = {
    "gemma3-1b": gemma3_1b.SMOKE,
    "qwen3-32b": qwen3_32b.SMOKE,
    "mistral-nemo-12b": mistral_nemo_12b.SMOKE,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mwis", choices=ARCHES)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    # mwis-only knobs
    ap.add_argument("--algo", default="rg",
                    choices=("greedy", "rg", "rnp"))
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "blocked", "cuda"))
    ap.add_argument("--repeat-topologies", type=int, default=4,
                    help="requests sharing one topology (fresh weights)")
    ap.add_argument("--verify", default="off",
                    choices=("off", "sample", "full"),
                    help="post-solve output audit (independence + weight)")
    ap.add_argument("--descent", default="off", choices=("off", "auto"),
                    help="shape descent: big cells shrink mid-solve and "
                         "oversize instances enter via descent cells")
    ap.add_argument("--devices", type=int, default=None,
                    help="serve-mesh size for the sharded batch axis "
                         "(default: every visible device; exits with an "
                         "error when more are requested than exist)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable the overlapped chunk pipeline (chunks "
                         "run synchronously)")
    ap.add_argument("--device", default="cuda",
                    help="device type it serves on (cuda | cpu)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def make_requests(cells, n_requests: int, repeat: int, seed: int) -> list:
    """The reference's instance stream: cycle the cells, one GNM topology
    at n = 0.8 L, m = min(2n, E/4) per step, each repeated ``repeat``
    times with fresh weights in [1, 200] (the re-auction pattern)."""
    rng = np.random.default_rng(seed)
    reqs = []
    topo = 0
    while len(reqs) < n_requests:
        cell = cells[topo % len(cells)]
        n = int(cell.L * 0.8)
        m = min(2 * n, cell.E // 4)
        g = gnm(n, m, seed=seed + topo)
        for _ in range(repeat):
            w = rng.integers(1, 201, size=g.n).astype(np.int32)
            reqs.append(type(g)(indptr=g.indptr, indices=g.indices,
                                weights=w))
            if len(reqs) == n_requests:
                break
        topo += 1
    return reqs


def serve_mwis(args: argparse.Namespace) -> dict:
    """Build the service, drive the stream (one warm-up pass, one timed
    pass, one pass for the solution weights), print the reference's lines;
    returns the service, the throughput record and the last pass's
    results."""
    cfg = SV.ServeConfig(algo=args.algo, backend=args.backend,
                         max_batch=args.batch, verify=args.verify,
                         descent=args.descent, devices=args.devices,
                         pipeline=not args.no_pipeline, device=args.device)
    try:
        svc = SV.MWISService(cfg)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)
    cells = svc.cells
    print(f"mwis service: algo={cfg.algo} backend={cfg.backend} "
          f"verify={cfg.verify} descent={cfg.descent} "
          f"batch<={cfg.max_batch} cells="
          f"{[f'{c.name}(L={c.L},E={c.E})' for c in cells]}")
    kind = svc.device.type
    print(f"devices: {svc.stats['devices']}/"
          f"{len(mesh.visible_devices(kind))} visible ({kind}) "
          f"pipeline={'on' if cfg.pipeline else 'off'}")

    reqs = make_requests(cells, args.requests, args.repeat_topologies,
                         args.seed)
    batches = [reqs[i:i + args.batch]
               for i in range(0, len(reqs), args.batch)]
    stats = SV.measure_throughput(svc, batches, warmup=1)
    tot_w = 0
    n_err = 0
    results = []
    for b in batches:
        rs = svc.solve_batch(list(b))
        results.extend(rs)
        tot_w += sum(r.weight for r in rs)
        n_err += sum(not r.ok for r in rs)
    print(f"requests={stats['instances']} batches={stats['batches']} "
          f"throughput={stats['instances_per_sec']:.1f} inst/s")
    print(f"p50={stats['p50_ms']:.2f}ms p99={stats['p99_ms']:.2f}ms "
          f"(per-batch latency)")
    print(f"total solution weight (last pass): {tot_w} "
          f"({n_err} per-request errors)")
    s = svc.stats
    print(f"cache: hits={s['cache_hits']} misses={s['cache_misses']} "
          f"evictions={s['cache_evictions']} errors={s['cache_errors']} "
          f"size={s['cache_size']} programs={s['programs']} "
          f"compiles={s['compiles']}")
    print(f"robustness: backend={s['backend']}"
          f"{'' if s['backend_active'] == s['backend'] else ' -> ' + s['backend_active']} "
          f"rejected={s['rejected']} repaired={s['repaired']} "
          f"pack_errors={s['pack_errors']} solve_errors={s['solve_errors']} "
          f"fallbacks={s['fallbacks']} "
          f"verified={s['verify_checked']}/{s['verify_failures']} "
          f"(checked/failed)")
    print(f"descent: mode={cfg.descent} "
          f"solves={s['descent_solves']} descents={s['descents']} "
          f"oversize_admitted={s['oversize_admitted']} "
          f"plan_cache_hits={s['cache_descent_hits']}/"
          f"{s['cache_descent_hits'] + s['cache_descent_misses']}")
    p50 = s["stage_p50_ms"]
    print(f"stages (p50/chunk): pack={p50['pack']:.2f}ms "
          f"transfer={p50['transfer']:.2f}ms solve={p50['solve']:.2f}ms "
          f"fetch={p50['fetch']:.2f}ms")
    print(f"pipeline: devices={s['devices']} chunks={s['chunks']} "
          f"pipelined={s['pipelined_chunks']} "
          f"retries={s['pipeline_retries']} "
          f"overlap_ratio={s['overlap_ratio']:.3f}")
    return dict(service=svc, throughput=stats, requests=reqs,
                results=results)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_dlrm(args: argparse.Namespace) -> dict:
    """Score ``args.requests`` batches with the SMOKE DLRM, one request at
    a time (the reference's loop and lines; the first request's latency
    is left out of p50 / p99); returns the per-request latencies (ms) and
    mean CTRs."""
    cfg = dlrm_mlperf.SMOKE
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = DM.DLRM(cfg, MC.init_params(DM.param_specs(cfg), gen, dev))
    spec = DLRMBatchSpec(args.batch, cfg.n_dense, cfg.n_sparse, cfg.vocabs)
    lat, ctr = [], []
    with torch.no_grad():
        for r in range(args.requests):
            b = dlrm_batch(spec, r)
            b.pop("labels")
            t0 = time.perf_counter()
            probs = DM.serve_step(
                model, {k: torch.from_numpy(v).to(dev) for k, v in b.items()},
                cfg)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            ctr.append(float(probs.mean()))
            print(f"request {r}: batch={args.batch} "
                  f"mean_ctr={ctr[-1]:.4f} "
                  f"lat={lat[-1]:.2f}ms")
    warm = np.asarray(lat[1:])
    print(f"p50={np.percentile(warm, 50):.2f}ms "
          f"p99={np.percentile(warm, 99):.2f}ms")
    return dict(latencies_ms=lat, mean_ctr=ctr)


def serve_lm(args: argparse.Namespace) -> dict:
    """Greedy-decode ``args.tokens`` tokens for a batch of ``args.batch``
    with the arch's SMOKE config, from token 0 against a zeroed cache of
    ``tokens + 8`` positions (the reference's loop and line; the time
    includes the first step's set-up); returns the seconds, the last
    step's logits and the greedy tokens ``[batch, tokens]``."""
    cfg = LM_SMOKES[args.arch]
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = TM.Transformer(cfg, MC.init_params(TM.param_specs(cfg), gen, dev))
    B, S = args.batch, args.tokens + 8
    ((k_shape, k_dtype), (v_shape, v_dtype)), _ = TM.make_kv_cache_specs(
        cfg, B, S)
    kc = torch.zeros(k_shape, dtype=k_dtype, device=dev)
    vc = torch.zeros(v_shape, dtype=v_dtype, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    toks = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(args.tokens):
            logits, (kc, vc) = TM.serve_step(model, (kc, vc), tok, t, cfg)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            toks.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x batch {B} in {dt:.2f}s "
          f"({args.tokens * B / dt:.1f} tok/s, incl. the first step)")
    return dict(seconds=dt, logits=logits, tokens=torch.cat(toks, 1))


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.arch == "mwis":
        serve_mwis(args)["service"].close()
    elif args.arch == "dlrm-mlperf":
        serve_dlrm(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
