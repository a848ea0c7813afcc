"""Reduced-config smoke runner of the LM family: instantiate a small config
and run one AdamW train step and one decode step against a KV cache,
asserting output shapes and finiteness.

The port of ``repro/configs/smoke_runners.py``'s ``lm_smoke``.  Its
``dlrm_smoke`` waits for the ``embedding_bag`` backward (ROADMAP Queue 1
item 2) and ``gnn_smoke`` for the GNN models (item 3); ``mwis_smoke`` is
covered by the port's solver tests.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import common as MC
from repro_torch.models import transformer as TM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import lm_train_step


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
    loss, params2, _ = lm_train_step(params, opt.adamw_init(params), batch,
                                     cfg, opt.adamw_update,
                                     opt.AdamWConfig())
    assert bool(torch.isfinite(loss)), "train loss must be finite"
    _assert_finite(params2, f"{cfg.name} params after update")

    # decode step against a KV cache
    (k_shape, k_dt), (v_shape, v_dt) = TM.make_kv_cache_specs(cfg, B, 64)
    kc = torch.zeros(k_shape, dtype=k_dt, device=dev)
    vc = torch.zeros(v_shape, dtype=v_dt, device=dev)
    with torch.no_grad():
        logits, _ = TM.serve_step(
            TM.Transformer(cfg, params), (kc, vc),
            torch.zeros((B, 1), dtype=torch.int32, device=dev), 3, cfg)
    assert logits.shape == (B, cfg.vocab)
    _assert_finite(logits, f"{cfg.name} decode logits")
