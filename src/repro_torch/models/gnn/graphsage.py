"""GraphSAGE (Hamilton et al. [arXiv:1706.02216]) — mean aggregator,
2 layers, fanout sampling (25-10 for the Reddit config).

    h'_v = ReLU( W_self h_v + W_nbr · mean_{u∈sample(N(v))} h_u )

The port of ``repro/models/gnn/graphsage.py``.  The sampled-training shape
(``minibatch_lg``) consumes subgraphs produced by
:mod:`repro_torch.graphs.sampler`; full-batch shapes pass the whole edge
list.  One plan of ``col`` serves every layer's mean.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import common as C
from repro_torch.models.common import ParamSpec
from repro_torch.models.gnn import common as G


@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_feat: int = 602
    n_classes: int = 41
    sample_sizes: tuple = (25, 10)
    dtype: Any = torch.float32


def param_specs(cfg: GraphSAGEConfig, fsdp=("data",)) -> Dict[str, Any]:
    S = ParamSpec
    specs: Dict[str, Any] = {}
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        d_out = cfg.d_hidden
        specs[f"l{i}_self"] = S((d_in, d_out), cfg.dtype, (None, "model"))
        specs[f"l{i}_nbr"] = S((d_in, d_out), cfg.dtype, (None, "model"))
        specs[f"l{i}_b"] = S((d_out,), cfg.dtype, (None,), init="zeros")
        d_in = d_out
    specs["out_w"] = S((d_in, cfg.n_classes), cfg.dtype, ("model", None))
    specs["out_b"] = S((cfg.n_classes,), cfg.dtype, (None,), init="zeros")
    return specs


class GraphSAGE(C.TreeModel):
    """GraphSAGE's weights and its config (``common.TreeModel``)."""

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return forward(self, batch, self.cfg)


#: The family's module class (what ``train.step`` builds).
MODEL = GraphSAGE


def plans(batch: Dict[str, Any], cfg: GraphSAGEConfig) -> Dict[str, Any]:
    """The forward's scatter plans (host packing, from the batch's host
    copies where it has them): ``col``'s live edges."""
    n, dev = batch["node_feat"].shape[0], batch["node_feat"].device
    hb = G.host_view(batch)
    return {"col": G.scatter_plan(hb["col"], n, hb["row"] < n, device=dev,
                                  like=batch["col"], rows=("fsdp",))}


def forward(params: GraphSAGE, batch: Dict[str, Any],
            cfg: GraphSAGEConfig) -> torch.Tensor:
    n = batch["node_feat"].shape[0]
    row = batch["row"].long()
    emask = row < n
    plan = plans(batch, cfg)["col"]
    h = batch["node_feat"].to(cfg.dtype)
    for i in range(cfg.n_layers):
        hp = G.pad_row(h)
        agg = G.scatter_mean(G.gather_rows(hp, row), plan, mask=emask)
        h = C.relu(
            G.linear(h, getattr(params, f"l{i}_self"))
            + G.linear(agg, getattr(params, f"l{i}_nbr"))
            + getattr(params, f"l{i}_b"))
        # L2 normalisation as in the paper (jnp.linalg.norm's sqrt of the
        # sum of squares)
        norm = torch.sqrt((h * h).sum(-1, keepdim=True))
        h = h / torch.clamp(norm, min=1e-6)
    return G.linear(h, params.out_w) + params.out_b


def loss_fn(params: GraphSAGE, batch: Dict[str, Any],
            cfg: GraphSAGEConfig) -> torch.Tensor:
    logits = forward(params, batch, cfg)
    return G.node_xent_loss(logits, batch["labels"], batch["label_mask"])
