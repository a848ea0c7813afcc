"""GatedGCN (Bresson & Laurent; benchmark config of Dwivedi et al.
[arXiv:2003.00982]): edge-gated message passing with residuals + LayerNorm.

    e'_uv = E1 h_u + E2 h_v + E3 e_uv
    h'_v  = h_v + ReLU(LN( U h_v + Σ_u σ(e'_uv) ⊙ (V h_u) / (Σ σ + ε) ))

The port of ``repro/models/gnn/gatedgcn.py``: the reference's
``lax.scan`` over the stacked ``[L, d, d]`` layers is a loop over their
slices (``common.layer_slices``); one plan of ``col`` serves every layer's
two sums.  On a mesh the edge products go through ``common.linear`` (the
model-sharded weights stay in place, as GSPMD keeps them) and the edge
state is broadcast to each rank's own edges (``common.expand_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import common as C
from repro_torch.models.common import ParamSpec
from repro_torch.models.gnn import common as G

#: The stacked per-layer weights.
MATS = ("U", "V", "E1", "E2", "E3")
NORMS = ("ln_h_g", "ln_h_b", "ln_e_g", "ln_e_b")


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    """The reference's config less ``probe_unroll`` (a scan unroll for the
    TPU dry-run; the port has no scan)."""
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 1433
    n_classes: int = 40
    dtype: Any = torch.float32


def param_specs(cfg: GatedGCNConfig, fsdp=("data",)) -> Dict[str, Any]:
    L, d = cfg.n_layers, cfg.d_hidden
    S = ParamSpec
    return {
        "embed_w": S((cfg.d_feat, d), cfg.dtype, (None, "model")),
        "embed_b": S((d,), cfg.dtype, (None,), init="zeros"),
        "edge_embed": S((1, d), cfg.dtype, (None, None)),
        "layers": {
            k: S((L, d, d), cfg.dtype, (None, None, "model")) for k in MATS
        } | {
            "ln_h_g": S((L, d), cfg.dtype, (None, None), init="ones"),
            "ln_h_b": S((L, d), cfg.dtype, (None, None), init="zeros"),
            "ln_e_g": S((L, d), cfg.dtype, (None, None), init="ones"),
            "ln_e_b": S((L, d), cfg.dtype, (None, None), init="zeros"),
        },
        "out_w": S((d, cfg.n_classes), cfg.dtype, ("model", None)),
        "out_b": S((cfg.n_classes,), cfg.dtype, (None,), init="zeros"),
    }


class GatedGCN(C.TreeModel):
    """GatedGCN's weights and its config (``common.TreeModel``)."""

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return forward(self, batch, self.cfg)


#: The family's module class (what ``train.step`` builds).
MODEL = GatedGCN


def plans(batch: Dict[str, Any], cfg: GatedGCNConfig) -> Dict[str, Any]:
    """The forward's scatter plans (host packing, from the batch's host
    copies where it has them): ``col``'s live edges."""
    n, dev = batch["node_feat"].shape[0], batch["node_feat"].device
    hb = G.host_view(batch)
    return {"col": G.scatter_plan(hb["col"], n, hb["row"] < n, device=dev,
                                  like=batch["col"], rows=("fsdp",))}


def forward(params: GatedGCN, batch: Dict[str, Any],
            cfg: GatedGCNConfig) -> torch.Tensor:
    """batch: node_feat [N, F], row/col [E] (sentinel N for padding)."""
    n = batch["node_feat"].shape[0]
    row, col = batch["row"].long(), batch["col"].long()
    emask = row < n
    plan = plans(batch, cfg)["col"]
    h = G.linear(batch["node_feat"].to(cfg.dtype), params.embed_w) \
        + params.embed_b
    e = G.expand_rows(params.edge_embed, row)
    layers = C.layer_slices({k: getattr(params.layers, k)
                             for k in MATS + NORMS})
    for lp in layers:
        hp = G.pad_row(h)
        hu, hv = G.gather_rows(hp, row), G.gather_rows(hp, col)
        e_new = (G.linear(hu, lp["E1"]) + G.linear(hv, lp["E2"])
                 + G.linear(e, lp["E3"]))
        e_new = G.layer_norm(e_new, lp["ln_e_g"], lp["ln_e_b"])
        gate = torch.sigmoid(e_new) * emask[:, None]
        msg = gate * G.linear(hu, lp["V"])
        agg = G.scatter_sum(msg, plan)
        den = G.scatter_sum(gate, plan) + 1e-6
        upd = G.linear(h, lp["U"]) + agg / den
        upd = G.layer_norm(upd, lp["ln_h_g"], lp["ln_h_b"])
        h = h + C.relu(upd)
        e = e + C.relu(e_new)
    return G.linear(h, params.out_w) + params.out_b


def loss_fn(params: GatedGCN, batch: Dict[str, Any],
            cfg: GatedGCNConfig) -> torch.Tensor:
    logits = forward(params, batch, cfg)
    return G.node_xent_loss(logits, batch["labels"], batch["label_mask"])
