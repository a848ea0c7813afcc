"""Config/arch plumbing for the dry-run: every architecture registers an
:class:`ArchDef` whose ``build(shape, overrides)`` returns the cell's step,
a function that makes its inputs on a device from a seed, and the
reference's model FLOPs (``launch/dryrun.py`` counts one run of the step
under ``analysis.count``).  The same ArchDef carries the arch's reduced
smoke config.

The port of ``repro/configs/base.py``: the shape tables (``MWIS_SHAPES``
lives in ``configs/mwis.py`` and is re-exported here), :class:`BuildResult`,
:class:`ArchDef`, :func:`pad_multiple`, the abstract inputs (:func:`sds`,
:func:`opt_abstract`) and the four family builders.  Steps train through
``train/step.py`` with AdamW at its defaults, as the reference's do.  A
probe point (fewer layers, a smaller batch, fewer table rows) comes in
through ``overrides``.

The reference's shardings (:func:`fsdp_axes_for`, :func:`sharding_tree`,
:func:`opt_shardings`, :func:`ns`) are DTensor placements on a
``DeviceMesh`` here.  ``make_inputs("meta", seed, mesh)`` lays a cell's
inputs out on ``mesh`` as the reference's ``in_shardings`` do (the
weights by their specs, the optimizer state as the weights, the batch
over the FSDP axes, the decode cache by
``transformer.make_kv_cache_specs``, retrieval's candidates over the FSDP
axes, a GNN's edges over fsdp + ``model``): DTensors whose local shards
are meta tensors, one rank's inputs of the dry-run's sharded count (a
GNN cell's also on ``"cpu"``: each rank's blocks).

``make_inputs(device, seed)`` makes a cell's inputs.  The index arrays
whose data sets work that the host packs or a kernel formula counts (the
GNNs' edge ends, triplets and graph ids; DLRM's ids) are drawn on the
host, from ``seed``, on every device; the batch holds them on its device
and carries the host copies under ``"host"``, so that a count on one
device equals the count on another.  On ``"meta"`` (the dry-run's
abstract count, which holds no tensor of the cell) the weights come from
``models.common.abstract_params``, the optimizer state from
:func:`opt_abstract` and the float and token inputs from :func:`sds`, and
no device ``torch.Generator`` is made.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import is_dtensor, resolve_device
from repro_torch.models import common as MC
from repro_torch.train import optimizer as opt
from repro_torch.train.step import train_step


# --------------------------------------------------------------------- #
# LM shape cells (seq_len × global_batch; decode shapes run serve_step)
# --------------------------------------------------------------------- #
LM_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

GNN_SHAPES: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_graphs=1),
    "minibatch_lg": dict(kind="train", n_nodes=169984, n_edges=168960,
                         d_feat=602, n_graphs=1, sampled=True,
                         batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_graphs=1),
    "molecule": dict(kind="train", n_nodes=3840, n_edges=8192, d_feat=16,
                     n_graphs=128),
}

RECSYS_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def __getattr__(name: str):
    # MWIS_SHAPES is configs/mwis.py's, which imports this module
    if name == "MWIS_SHAPES":
        from repro_torch.configs.mwis import MWIS_SHAPES
        return MWIS_SHAPES
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class BuildResult:
    fn: Callable                  # the step: fn(*inputs) -> outputs
    make_inputs: Callable         # make_inputs(device, seed) -> inputs
    # static metadata for the roofline
    model_flops: float
    note: str = ""
    #: measure(device, seed) -> (outputs, count record), for a step whose
    #: work is counted in other processes (MWIS: one rank a PE); None:
    #: ``analysis.count.measure`` of ``fn`` on ``make_inputs``'s inputs
    measure: Optional[Callable] = None
    #: the cell's model config, overrides applied (the dry-run reads an
    #: LM's layer pattern)
    cfg: Any = None


@dataclasses.dataclass
class ArchDef:
    arch_id: str
    family: str                      # lm | gnn | recsys | mwis
    shapes: Tuple[str, ...]
    build: Callable[..., BuildResult]  # build(shape, overrides=None)
    smoke: Callable[..., Any]        # runs a reduced config (device=)
    skips: Dict[str, str] = dataclasses.field(default_factory=dict)


def pad_multiple(x: int, m: int = 512) -> int:
    return ((x + m - 1) // m) * m


def _replace(cfg, overrides: Optional[Dict[str, Any]]):
    """``cfg`` with the overrides that name one of its fields."""
    if not overrides:
        return cfg
    return dataclasses.replace(
        cfg, **{k: v for k, v in overrides.items() if hasattr(cfg, k)})


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: an input of the abstract
    count, which holds no memory (the reference's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def opt_abstract(params_abs) -> opt.AdamWState:
    """The AdamW state of ``params_abs`` on meta: the int32 step and the
    float32 moments, shaped as ``optimizer.adamw_init`` makes them; no
    init runs.  DTensor weights give DTensor moments of the same
    placements and a replicated step (``opt_shardings``)."""
    def f32(p):
        if is_dtensor(p):
            return MC.abstract_dtensor(p.shape, torch.float32, p.placements,
                                       p.device_mesh)
        return sds(p.shape, torch.float32)

    first = opt.leaves(params_abs)[0]
    if is_dtensor(first):
        mesh = first.device_mesh
        step = MC.abstract_dtensor((), torch.int32, ns(mesh), mesh)
    else:
        step = sds((), torch.int32)
    return opt.AdamWState(step=step, mu=opt.tree_map(f32, params_abs),
                          nu=opt.tree_map(f32, params_abs))


def fsdp_axes_for(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names
    return tuple(a for a in names if a in ("pod", "data"))


def sharding_tree(specs, mesh):
    return MC.param_shardings(specs, mesh)


def opt_shardings(param_sh, mesh) -> opt.AdamWState:
    """The AdamW state's placements: the step replicated, the moments as
    the weights."""
    return opt.AdamWState(step=ns(mesh), mu=param_sh, nu=param_sh)


def ns(mesh, *spec, shape=None) -> tuple:
    """The placements of ``spec`` on ``mesh`` (sanitised for ``shape``
    where it is given: the reference's ``NamedSharding``; without a shape
    every named dim must divide)."""
    if shape is None:
        shape = (0,) * len(spec)      # 0 divides by every axis
    return MC.placements(tuple(shape), spec, mesh)


def sharded(x: torch.Tensor, mesh, *spec) -> torch.Tensor:
    """An input ``x`` as a DTensor on ``mesh`` laid out by ``spec``
    (sanitised): a meta ``x`` as a meta shard of its shape and dtype,
    another as this rank's block of it (every rank makes ``x`` whole from
    the seed; ``models.common.local_dtensor``)."""
    places = ns(mesh, *spec, shape=x.shape)
    if x.device.type == "meta":
        return MC.abstract_dtensor(tuple(x.shape), x.dtype, places, mesh)
    return MC.local_dtensor(x, places, mesh)


def _generator(device, seed: int
               ) -> Tuple[torch.device, Optional[torch.Generator]]:
    """The device and its generator (None on meta, which draws nothing)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return dev, None
    return dev, torch.Generator(device=dev).manual_seed(seed)


def _params(specs, gen, dev):
    if dev.type == "meta":
        return MC.abstract_params(specs)
    return MC.init_params(specs, gen, dev)


def _train_inputs(params, dev) -> Tuple[Any, Any]:
    """``params`` and their AdamW state (abstract on meta)."""
    if dev.type == "meta":
        return params, opt_abstract(params)
    return params, opt.adamw_init(params)


def _randn(gen, dev, shape) -> torch.Tensor:
    if dev.type == "meta":
        return sds(shape, torch.float32)
    return torch.randn(shape, generator=gen, device=dev)


def _randint(gen, dev, high: int, shape) -> torch.Tensor:
    if dev.type == "meta":
        return sds(shape, torch.int32)
    return torch.randint(0, high, shape, generator=gen, device=dev,
                         dtype=torch.int32)


# --------------------------------------------------------------------- #
# family builders
# --------------------------------------------------------------------- #
def lm_build(cfg, shape_name: str,
             overrides: Optional[Dict[str, Any]] = None) -> BuildResult:
    """A transformer cell; ``overrides`` may set config fields (the probes'
    ``n_layers``), ``batch`` and ``seq``."""
    from repro_torch.models import transformer as T

    meta = LM_SHAPES[shape_name]
    cfg = _replace(cfg, overrides)
    B = int((overrides or {}).get("batch", meta["batch"]))
    S = int((overrides or {}).get("seq", meta["seq"]))
    ocfg = opt.AdamWConfig()

    def tokens(gen, dev, shape, mesh=None):
        t = _randint(gen, dev, cfg.vocab, shape)
        return t if mesh is None else sharded(t, mesh, fsdp_axes_for(mesh))

    def weights(gen, dev, mesh):
        if mesh is None:
            return _params(T.param_specs(cfg), gen, dev)
        _require_meta(dev)
        return MC.abstract_sharded_params(
            T.param_specs(cfg, fsdp_axes_for(mesh)), mesh)

    if meta["kind"] == "train":
        def make_inputs(device, seed: int, mesh=None):
            dev, gen = _generator(device, seed)
            params, ostate = _train_inputs(weights(gen, dev, mesh), dev)
            batch = {k: tokens(gen, dev, (B, S), mesh)
                     for k in ("tokens", "labels")}
            return params, ostate, batch

        def train(params, ostate, batch):
            return train_step(params, ostate, batch, cfg, opt.adamw_update,
                              ocfg)

        flops = 6.0 * cfg.n_active_params() * B * S
        return BuildResult(train, make_inputs, flops, cfg=cfg)

    if meta["kind"] == "prefill":
        def make_inputs(device, seed: int, mesh=None):
            dev, gen = _generator(device, seed)
            return weights(gen, dev, mesh), tokens(gen, dev, (B, S), mesh)

        @torch.no_grad()
        def prefill(params, toks):
            return T.prefill_step(T.Transformer(cfg, params), toks, cfg)

        flops = 2.0 * cfg.n_active_params() * B * S
        return BuildResult(prefill, make_inputs, flops, cfg=cfg)

    # decode: one new token against a seq-long KV cache
    def make_inputs(device, seed: int, mesh=None):
        dev, gen = _generator(device, seed)
        params = weights(gen, dev, mesh)
        fsdp = ("data",) if mesh is None else fsdp_axes_for(mesh)
        ((k_shape, k_dt), (v_shape, v_dt)), (k_ps, v_ps) = (
            T.make_kv_cache_specs(cfg, B, S, fsdp, shard_seq=B == 1))
        kc = torch.zeros(k_shape, dtype=k_dt, device=dev)
        vc = torch.zeros(v_shape, dtype=v_dt, device=dev)
        if mesh is not None:
            kc, vc = sharded(kc, mesh, *k_ps), sharded(vc, mesh, *v_ps)
        return params, kc, vc, tokens(gen, dev, (B, 1), mesh), S - 1

    @torch.no_grad()
    def decode(params, kc, vc, toks, cache_len):
        logits, (kc, vc) = T.serve_step(T.Transformer(cfg, params), (kc, vc),
                                        toks, cache_len, cfg)
        return logits, kc, vc

    flops = 2.0 * cfg.n_active_params() * B
    return BuildResult(decode, make_inputs, flops,
                       note="decode against %d-token cache" % S, cfg=cfg)


def _require_meta(dev: torch.device) -> None:
    if dev.type != "meta":
        raise ValueError(f"inputs laid out on a mesh are meta DTensors "
                         f"(the sharded count), not {dev.type} tensors")


def gnn_build(module, cfg, shape_name: str,
              overrides: Optional[Dict[str, Any]] = None,
              *, molecular: bool, flops_fn) -> BuildResult:
    """A GNN training cell on a random graph of the shape's sizes, padded
    as the reference's data pipeline pads (N and 2·edges to multiples of
    512, padding on the sentinel node N); ``overrides`` may set config
    fields (the probes' layer count).

    ``make_inputs(device, seed, mesh)`` lays the same inputs out on
    ``mesh`` as the reference's ``in_shardings``: the weights by their
    specs (``module.param_specs(cfg, fsdp)``) and the AdamW state as the
    weights; node arrays (features, labels, mask, ``pos``, ``batch_id``)
    over the fsdp axes; ``row``, ``col`` and ``triplets`` over fsdp +
    ``model``; ``energy`` replicated.  On ``"meta"`` they are meta
    DTensors (the sharded count), on ``"cpu"`` each rank's blocks of the
    inputs it made whole (the CPU check of the rules).  The host copies
    (``batch["host"]``) are then this rank's slices of the index arrays,
    their values global ids, and ``batch["host_whole"]`` the whole
    arrays they were cut from."""
    meta = GNN_SHAPES[shape_name]
    cfg = _replace(cfg, overrides)
    # data pipeline pads node/edge counts to shardable multiples
    N = pad_multiple(meta["n_nodes"])
    E2 = pad_multiple(2 * meta["n_edges"])
    d_feat = meta["d_feat"]
    cfg = dataclasses.replace(cfg, d_feat=d_feat)
    ocfg = opt.AdamWConfig()

    def make_inputs(device, seed: int, mesh=None):
        dev, gen = _generator(device, seed)
        rng = np.random.default_rng(seed)
        n, e = meta["n_nodes"], 2 * meta["n_edges"]
        ends = np.full((2, E2), N, np.int32)
        ends[:, :e] = rng.integers(0, n, (2, e), dtype=np.int32)
        host = dict(row=torch.from_numpy(ends[0]),
                    col=torch.from_numpy(ends[1]))
        batch = dict(
            node_feat=_randn(gen, dev, (N, d_feat)),
            labels=_randint(gen, dev, getattr(cfg, "n_classes", 2), (N,)),
            label_mask=(torch.arange(N, device=dev) < n).float(),
        )
        if molecular:
            G = meta["n_graphs"]
            T_budget = min(8 * E2, 1 << 24)
            host.update(
                batch_id=(torch.arange(N) * G // N).to(torch.int32),
                triplets=torch.from_numpy(rng.integers(
                    0, e, (T_budget, 2), dtype=np.int32)))
            batch.update(pos=_randn(gen, dev, (N, 3)),
                         energy=_randn(gen, dev, (G,)), n_graphs=G)
        batch.update({k: v.to(dev) for k, v in host.items()}, host=host)
        params, ostate = _train_inputs(
            _params(module.param_specs(cfg), gen, dev), dev)
        if mesh is None:
            return params, ostate, batch
        return _gnn_on_mesh(module.param_specs(cfg, fsdp_axes_for(mesh)),
                            params, ostate, batch, mesh)

    def train(params, ostate, batch):
        return train_step(params, ostate, batch, cfg, opt.adamw_update, ocfg,
                          model_cls=module.MODEL, loss_fn=module.loss_fn)

    return BuildResult(train, make_inputs, flops_fn(cfg, N, E2), cfg=cfg)


#: The reference's layout of a GNN batch (``gnn_build``'s ``batch_sh``):
#: node arrays over the fsdp axes ("fsdp"), edge arrays over fsdp +
#: ``model`` ("edges"), the rest replicated.
GNN_BATCH_SPECS = {
    "node_feat": ("fsdp", None), "labels": ("fsdp",),
    "label_mask": ("fsdp",), "pos": ("fsdp", None), "batch_id": ("fsdp",),
    "row": ("edges",), "col": ("edges",), "triplets": ("edges", None),
    "energy": (None,),
}


def _gnn_on_mesh(specs, params, ostate, batch, mesh):
    """A GNN cell's inputs (made whole on one device) laid out on
    ``mesh`` (``gnn_build``'s docstring); the host copies cut to this
    rank's slices."""
    f = fsdp_axes_for(mesh)
    axes = {"fsdp": f, "edges": f + ("model",), None: None}

    def tree(p, s):
        return {k: tree(p[k], s[k]) if isinstance(p[k], dict)
                else sharded(p[k], mesh, *s[k].pspec) for k in sorted(p)}

    params = tree(params, specs)
    ostate = opt.AdamWState(step=sharded(ostate.step, mesh),
                            mu=tree(ostate.mu, specs),
                            nu=tree(ostate.nu, specs))
    out = dict(batch)
    for k, spec in GNN_BATCH_SPECS.items():
        if k in batch:
            out[k] = sharded(batch[k], mesh, *(axes[a] for a in spec))
    out["host"] = {k: v[MC.block_slices(tuple(v.shape), out[k].placements,
                                        mesh)]
                   for k, v in batch["host"].items()}
    out["host_whole"] = batch["host"]
    return params, ostate, out


def dlrm_build(cfg, shape_name: str,
               overrides: Optional[Dict[str, Any]] = None) -> BuildResult:
    """A DLRM cell; ``overrides`` may set config fields and cap every table
    at ``row_cap`` rows (the probes' table-rows axis; ids are drawn below
    each capped vocabulary).  The ids are drawn on the host from the seed
    (``make_inputs`` in the module's docstring); a retrieval's candidates,
    whose values set no work, on the device."""
    from repro_torch.models import dlrm as M

    meta = RECSYS_SHAPES[shape_name]
    cfg = _replace(cfg, overrides)
    cap = (overrides or {}).get("row_cap")
    if cap is not None:
        cfg = dataclasses.replace(
            cfg, vocabs=tuple(min(v, int(cap)) for v in cfg.vocabs))
    B = meta["batch"]
    ocfg = opt.AdamWConfig()

    top_dims = (cfg.top_in,) + cfg.top_mlp
    mlp_flops = sum(
        a * b for a, b in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:])
    ) + sum(a * b for a, b in zip(top_dims[:-1], top_dims[1:]))
    fwd = 2.0 * B * (
        mlp_flops + (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
        + cfg.n_sparse * cfg.embed_dim
    )

    def features(gen, dev, seed: int, n: int, mesh=None):
        host_gen = torch.Generator().manual_seed(seed)
        sparse = torch.stack([
            torch.randint(0, v, (n,), generator=host_gen, dtype=torch.int32)
            for v in cfg.vocabs], 1)
        batch = dict(dense=_randn(gen, dev, (n, cfg.n_dense)),
                     sparse=sparse.to(dev), host=dict(sparse=sparse))
        if mesh is not None:
            f = fsdp_axes_for(mesh)
            batch.update(dense=sharded(batch["dense"], mesh, f, None),
                         sparse=sharded(batch["sparse"], mesh, f, None))
        return batch

    def weights(gen, dev, mesh):
        if mesh is None:
            return _params(M.param_specs(cfg), gen, dev)
        _require_meta(dev)
        return MC.abstract_sharded_params(
            M.param_specs(cfg, fsdp_axes_for(mesh)), mesh)

    if meta["kind"] == "train":
        def make_inputs(device, seed: int, mesh=None):
            dev, gen = _generator(device, seed)
            params, ostate = _train_inputs(weights(gen, dev, mesh), dev)
            batch = features(gen, dev, seed, B, mesh)
            labels = _randint(gen, dev, 2, (B,))
            batch["labels"] = labels if mesh is None else sharded(
                labels, mesh, fsdp_axes_for(mesh))
            return params, ostate, batch

        def train(params, ostate, batch):
            return train_step(params, ostate, batch, cfg, opt.adamw_update,
                              ocfg, model_cls=M.MODEL, loss_fn=M.loss_fn)

        return BuildResult(train, make_inputs, 3.0 * fwd, cfg=cfg)

    if meta["kind"] == "serve":
        def make_inputs(device, seed: int, mesh=None):
            dev, gen = _generator(device, seed)
            params = weights(gen, dev, mesh)
            return params, features(gen, dev, seed, B, mesh)

        @torch.no_grad()
        def serve(params, batch):
            return M.serve_step(M.DLRM(cfg, params), batch, cfg)

        return BuildResult(serve, make_inputs, fwd, cfg=cfg)

    # retrieval: 1 query × n_candidates batched dot
    nc = meta["n_candidates"]

    def make_inputs(device, seed: int, mesh=None):
        dev, gen = _generator(device, seed)
        params = weights(gen, dev, mesh)
        dense = _randn(gen, dev, (1, cfg.n_dense))
        cand = _randint(gen, dev, cfg.vocabs[0], (1, nc))
        if mesh is not None:
            dense = sharded(dense, mesh)
            cand = sharded(cand, mesh, None, fsdp_axes_for(mesh))
        return params, dict(dense=dense, candidates=cand)

    @torch.no_grad()
    def retrieve(params, batch):
        return M.retrieval_step(M.DLRM(cfg, params), batch, cfg)

    return BuildResult(retrieve, make_inputs, 2.0 * nc * cfg.embed_dim,
                       cfg=cfg)


def mwis_build(shape_name: str,
               overrides: Optional[Dict[str, Any]] = None) -> BuildResult:
    """The paper's workload: one sweep-round probe (one rule sweep, one
    heavy-vertex pass, one halo exchange: ``solvers.
    sweep_probe_shard_map_fn``) on ``pes`` spawned gloo ranks, one a PE
    (the per-PE path, ``launch/mesh.py``), all on the one device, over an
    RGG instance of pes × L vertices of average degree E / L, partitioned
    and padded to the cell's L, G, B and S.  The step is loop-free, so the dry-run's unit is one
    sweep-round (the full solve has data-dependent trip counts and is not
    built).

    ``overrides``: ``pes`` (default 4), ``heavy_k``, ``exchange``,
    ``schedule``, ``backend`` (default ``cuda``: the ``segment_fused``
    kernel through ``engine.aggregate``), ``use_heavy``, ``seg_blk``,
    ``seed`` (the instance's)."""
    from repro_torch.configs import mwis as _mwis
    from repro_torch.core import partition as part
    from repro_torch.core.distributed import DisReduConfig
    from repro_torch.graphs import generators as gen
    from repro_torch.launch import mesh

    meta = _mwis.MWIS_SHAPES[shape_name]
    ov = dict(overrides or {})
    pes = int(ov.get("pes", 4))
    L, E, G, B, S, D, Dc = (meta[k] for k in ("L", "E", "G", "B", "S", "D",
                                              "Dc"))
    seg_blk = dict(meta.get("seg_blk", {}))
    seg_blk.update(ov.get("seg_blk", {}))
    cfg = DisReduConfig(
        heavy_k=int(ov.get("heavy_k", 8)), mode="async", stale_sweeps=2,
        exchange=ov.get("exchange", "allgather"), max_rounds=64,
        schedule=str(ov.get("schedule", _mwis.rule_schedule(shape_name))),
        backend=str(ov.get("backend", "cuda")),
        use_heavy=bool(ov.get("use_heavy", True)),
        r_blk=seg_blk.get("r_blk"),
    )

    def make_inputs(device, seed: int):
        resolve_device(device)
        # E/L directed edges a vertex, so each PE holds about E; the edge
        # arrays keep the instance's own maximum: padding edges sit on the
        # nil row and would set every row block's ELL width
        g = gen.rgg2d(pes * L, avg_deg=E / L, seed=seed)
        return (part.partition_graph(g, pes, window_cap=D, common_cap=Dc,
                                     pad_to=dict(L=L, G=G, B=B, S=S)),)

    def probe(pg, device="cuda"):
        outs, _ = mesh.run_shard_map([pg], [mesh.PEJob("sweep", cfg)],
                                     backend="gloo", device=device)
        return outs[0]

    def measure(device, seed: int):
        (pg,) = make_inputs(device, seed)
        out = probe(pg, device)
        rec = rank_counts(out)
        rec["shape"] = {k: int(getattr(pg, k)) for k in "LEGBS"}
        return out, rec

    flops = 10.0 * pes * E
    return BuildResult(probe, make_inputs, flops,
                       note=f"algo=sweep-round p={pes} (one gloo rank a PE, "
                            f"all on one device)", measure=measure)


def rank_counts(out) -> Dict[str, Any]:
    """The count record of a ``sweep`` job of ``launch.mesh.run_shard_map``
    (its ``count``, one JSON record a rank, popped from ``out``): the
    ranks' records summed, ``run_s`` the slowest rank's."""
    import json

    recs = [json.loads(str(r)) for r in out.pop("count")]
    for r in recs:    # each rank's program order: no sum
        r.pop("collective_ops", None)
    rec = _sum_records(recs)
    rec["run_s"] = max(r["run_s"] for r in recs)
    return rec


def _sum_records(recs):
    """Sum count records key by key (numbers; dicts walked; strings kept;
    None stays None)."""
    first = recs[0]
    if isinstance(first, dict):
        keys = dict.fromkeys(k for r in recs for k in r)
        return {k: _sum_records([r[k] for r in recs if k in r]) for k in keys}
    if first is None or isinstance(first, str):
        return first
    if isinstance(first, list):
        return [sum(v) for v in zip(*recs)]
    return sum(recs)
