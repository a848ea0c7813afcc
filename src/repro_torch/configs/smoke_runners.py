"""Reduced-config smoke runners: instantiate a small config of a model
family and run one AdamW train step (and, where the family serves, its
serving steps), asserting output shapes and finiteness.

The port of ``repro/configs/smoke_runners.py``'s ``lm_smoke``,
``gnn_smoke`` and ``dlrm_smoke``: the same graph, batches and numpy draws
in the same order.  The weights come from a ``torch.Generator`` on the
device (seed 0), or from ``params`` where the caller passes a tree (the
tests pass the reference's, converted).  ``gnn_smoke`` and ``dlrm_smoke``
return the step's loss and updated weights.  ``mwis_smoke`` runs the
reference's reduced end-to-end MWIS solve.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import common as MC
from repro_torch.models import transformer as TM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import train_step


def _assert_finite(tree, what: str = "") -> None:
    for leaf in opt.leaves(tree):
        if leaf.is_floating_point():
            assert bool(torch.isfinite(leaf).all()), \
                f"non-finite values in {what}"


def lm_smoke(cfg: TM.TransformerConfig, device: str = "cuda") -> None:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = MC.init_params(TM.param_specs(cfg), gen, dev)
    B, S = 2, 32
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    loss, params2, _ = train_step(params, opt.adamw_init(params), batch,
                                  cfg, opt.adamw_update, opt.AdamWConfig())
    assert bool(torch.isfinite(loss)), "train loss must be finite"
    _assert_finite(params2, f"{cfg.name} params after update")

    # decode step against a KV cache
    ((k_shape, k_dt), (v_shape, v_dt)), _ = TM.make_kv_cache_specs(
        cfg, B, 64)
    kc = torch.zeros(k_shape, dtype=k_dt, device=dev)
    vc = torch.zeros(v_shape, dtype=v_dt, device=dev)
    with torch.no_grad():
        logits, _ = TM.serve_step(
            TM.Transformer(cfg, params), (kc, vc),
            torch.zeros((B, 1), dtype=torch.int32, device=dev), 3, cfg)
    assert logits.shape == (B, cfg.vocab)
    _assert_finite(logits, f"{cfg.name} decode logits")


def _tensors(batch: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """numpy leaves → tensors on ``dev``; ints (``n_graphs``) stay."""
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


def _step(model_cls, loss_fn, cfg, params, batch, what: str
          ) -> Tuple[float, MC.ParamTree]:
    """One AdamW step at the default config: (loss, updated params), both
    finite or it asserts."""
    loss, params2, _ = train_step(params, opt.adamw_init(params), batch, cfg,
                                  opt.adamw_update, opt.AdamWConfig(),
                                  model_cls=model_cls, loss_fn=loss_fn)
    assert bool(torch.isfinite(loss)), f"{what} loss must be finite"
    _assert_finite(params2, f"{what} params after update")
    return float(loss), params2


def gnn_smoke_batch(cfg: Any, *, molecular: bool,
                    sampled: bool = False) -> Dict[str, Any]:
    """The reference smoke runner's GNN batch (numpy): RGG n = 120 (avg
    degree 6, seed 0), fanout-sampled from 8 seeds into 160 nodes / 400
    edges when ``sampled``, draws from ``default_rng(0)`` in its order;
    molecular batches add positions, one graph and triplets at a budget
    of 4·E."""
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.sampler import build_triplets, sample_fanout

    rng = np.random.default_rng(0)
    g = gen.rgg2d(120, avg_deg=6, seed=0)
    if sampled:
        sub = sample_fanout(g, np.arange(8), cfg.sample_sizes, rng=rng,
                            pad_nodes=160, pad_edges=400)
        row, col, n = sub.row, sub.col, sub.n_sub
    else:
        row = g.edge_sources().astype(np.int32)
        col = g.indices.astype(np.int32)
        n = g.n
    d_feat = getattr(cfg, "d_feat", 16)
    batch = dict(
        node_feat=rng.normal(size=(n, d_feat)).astype(np.float32),
        row=row, col=col,
        labels=rng.integers(0, 4, size=n).astype(np.int32),
        label_mask=np.ones((n,), np.float32),
    )
    if molecular:
        tri = build_triplets(row, col, n, budget=4 * row.shape[0])
        batch.update(
            pos=rng.normal(size=(n, 3)).astype(np.float32),
            batch_id=np.zeros((n,), np.int32),
            energy=np.zeros((1,), np.float32),
            triplets=tri, n_graphs=1,
        )
    return batch


def gnn_smoke(module, cfg: Any, *, molecular: bool, sampled: bool = False,
              device: str = "cuda", params: MC.ParamTree | None = None
              ) -> Tuple[float, MC.ParamTree]:
    """One AdamW step of a GNN (``module``: one of ``models.gnn.*``) on
    :func:`gnn_smoke_batch`; returns (loss, updated params)."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = MC.init_params(module.param_specs(cfg), gen, dev)
    batch = _tensors(gnn_smoke_batch(cfg, molecular=molecular,
                                     sampled=sampled), dev)
    return _step(module.MODEL, module.loss_fn, cfg, params, batch, "gnn")


def dlrm_smoke_batches(cfg: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The reference smoke runner's DLRM batches (numpy), drawn from
    ``default_rng(0)`` in its order: a train batch of 16 (ids in [0, 3))
    and a retrieval query with 64 candidates of table 0."""
    rng = np.random.default_rng(0)
    B = 16
    batch = dict(
        dense=rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
        sparse=rng.integers(0, 3, size=(B, cfg.n_sparse)).astype(np.int32),
        labels=rng.integers(0, 2, size=B).astype(np.int32),
    )
    query = dict(
        dense=batch["dense"][:1],
        candidates=rng.integers(0, cfg.vocabs[0], size=(1, 64))
        .astype(np.int32),
    )
    return batch, query


def dlrm_smoke(cfg: Any, device: str = "cuda",
               params: MC.ParamTree | None = None
               ) -> Tuple[float, MC.ParamTree]:
    """One AdamW step of DLRM on :func:`dlrm_smoke_batches`' train batch,
    then ``serve_step`` and ``retrieval_step`` with the initial weights
    (as the reference); returns (loss, updated params)."""
    from repro_torch.models import dlrm as DM

    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = MC.init_params(DM.param_specs(cfg), gen, dev)
    batch, query = (_tensors(b, dev) for b in dlrm_smoke_batches(cfg))
    out = _step(DM.MODEL, DM.loss_fn, cfg, params, batch, "dlrm")
    model = DM.DLRM(cfg, params)
    with torch.no_grad():
        probs = DM.serve_step(model, {k: batch[k] for k in ("dense",
                                                            "sparse")}, cfg)
        scores = DM.retrieval_step(model, query, cfg)
    assert probs.shape == (batch["dense"].shape[0],)
    assert scores.shape == (query["candidates"].shape[1],)
    return out


def mwis_smoke(device: str = "cuda") -> None:
    """Reduced end-to-end MWIS: partition → DisReduA → RnP → verify."""
    from repro_torch.core import partition as part
    from repro_torch.core import solvers as S
    from repro_torch.core.distributed import DisReduConfig
    from repro_torch.graphs import generators as gen

    g = gen.rgg2d(200, avg_deg=6, seed=0)
    pg = part.partition_graph(g, 4, window_cap=8)
    members, _ = S.solve(pg, "rnp", DisReduConfig(heavy_k=6, mode="async"),
                         device=device)
    assert g.is_independent_set(members)
    assert g.set_weight(members) > 0
