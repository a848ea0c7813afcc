"""DimeNet (Gasteiger et al. [arXiv:2003.03123]) — directional message
passing over edge messages with a triplet (angular) interaction.

Messages live on *edges*; each interaction block aggregates over wedges
(k→j→i) with a radial×angular basis and a bilinear contraction
(n_bilinear = 8 down-projection as in DimeNet++).  The triplet set is
capped at a static budget (``graphs.sampler.build_triplets``).

The port of ``repro/models/gnn/dimenet.py``; the ``lax.scan`` over the
stacked blocks is a loop over their slices (``common.layer_slices``).
Three plans a forward:
``col`` (edges into nodes), ``to`` (triplets into their out-edge: only the
triplets ``tmask`` keeps, since the reference clamps every padding triplet
onto edge ``E - 1``) and ``batch_id`` (nodes into graphs).  On a mesh the
triplet sums and the energies are replicated and the node sums lie over
the fsdp axes, as XLA's program has them; the edge products with a
model-sharded weight go through ``common.linear``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.nn import functional as F

from repro_torch.models import common as C
from repro_torch.models.common import ParamSpec
from repro_torch.models.gnn import common as G

#: The stacked per-block weights.
BLOCK = ("w_msg", "w_down", "w_sbf", "w_up", "w_rbf_gate", "w_out1",
         "w_out2")


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    """The reference's config less ``probe_unroll`` (a scan unroll for the
    TPU dry-run; the port has no scan)."""
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat: int = 16          # species/feature input dim (projected in)
    cutoff: float = 5.0
    dtype: Any = torch.float32


def param_specs(cfg: DimeNetConfig, fsdp=("data",)) -> Dict[str, Any]:
    S = ParamSpec
    d, nb = cfg.d_hidden, cfg.n_blocks
    nsr = cfg.n_spherical * cfg.n_radial
    return {
        "embed_node": S((cfg.d_feat, d), cfg.dtype, (None, "model")),
        "embed_rbf": S((cfg.n_radial, d), cfg.dtype, (None, None)),
        "embed_msg": S((3 * d, d), cfg.dtype, (None, "model")),
        "blocks": {
            "w_msg": S((nb, d, d), cfg.dtype, (None, None, "model")),
            "w_down": S((nb, d, cfg.n_bilinear), cfg.dtype,
                        (None, None, None)),
            "w_sbf": S((nb, nsr, cfg.n_bilinear), cfg.dtype,
                       (None, None, None)),
            "w_up": S((nb, cfg.n_bilinear, d), cfg.dtype,
                      (None, None, "model")),
            "w_rbf_gate": S((nb, cfg.n_radial, d), cfg.dtype,
                            (None, None, None)),
            "w_out1": S((nb, d, d), cfg.dtype, (None, "model", None)),
            "w_out2": S((nb, d, d), cfg.dtype, (None, None, "model")),
        },
        "head_w1": S((d, d), cfg.dtype, (None, "model")),
        "head_w2": S((d, 1), cfg.dtype, ("model", None)),
    }


class DimeNet(C.TreeModel):
    """DimeNet's weights and its config (``common.TreeModel``)."""

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return forward(self, batch, self.cfg)


#: The family's module class (what ``train.step`` builds).
MODEL = DimeNet


def _triplet_ends(batch: Dict[str, Any], E: int):
    """(ti, to, tmask): in- and out-edge of each triplet, clamped to E - 1
    as the reference clamps them, and which triplets are real."""
    t_in, t_out = batch["triplets"][:, 0].long(), batch["triplets"][:, 1].long()
    tmask = (t_in < E) & (t_out < E)
    return torch.clamp(t_in, max=E - 1), torch.clamp(t_out, max=E - 1), tmask


def plans(batch: Dict[str, Any], cfg: DimeNetConfig) -> Dict[str, Any]:
    """The forward's scatter plans (host packing, from the batch's host
    copies where it has them): ``col``'s live edges, ``to``'s live
    triplets, ``batch_id``."""
    n, dev = batch["node_feat"].shape[0], batch["node_feat"].device
    hb = G.host_view(batch)
    E = batch["row"].shape[0]
    _, to, tmask = _triplet_ends(hb, E)
    # on a mesh: node sums onto rows over the fsdp axes, the triplets'
    # sums onto their (replicated) edges, the energies replicated
    return {"col": G.scatter_plan(hb["col"], n, hb["row"] < n, device=dev,
                                  like=batch["col"], rows=("fsdp",)),
            "to": G.scatter_plan(to, E, tmask, device=dev,
                                 like=batch["triplets"]),
            "batch_id": G.scatter_plan(hb["batch_id"], batch["n_graphs"],
                                       device=dev, like=batch["batch_id"])}


def forward(params: DimeNet, batch: Dict[str, Any],
            cfg: DimeNetConfig) -> torch.Tensor:
    """batch: pos [N,3], node_feat [N,F], row/col [E] (sentinel pads),
    triplets [T, 2] = (in-edge k→j, out-edge j→i), batch_id [N],
    n_graphs (an int) → energies per graph [n_graphs]."""
    n = batch["node_feat"].shape[0]
    row, col = batch["row"].long(), batch["col"].long()
    E = row.shape[0]
    emask = row < n
    pl = plans(batch, cfg)
    posp = G.pad_row(batch["pos"].to(cfg.dtype))
    vec = G.gather_rows(posp, col) - G.gather_rows(posp, row)
    dist = torch.linalg.vector_norm(vec + (~emask[:, None]) * 1.0, dim=-1)
    dirs = vec / torch.clamp(dist[:, None], min=1e-6)
    rbf = G.radial_basis(dist, cfg.n_radial, cfg.cutoff) * emask[:, None]

    h = G.linear(batch["node_feat"].to(cfg.dtype), params.embed_node)
    hp = G.pad_row(h)
    m = F.silu(G.linear(torch.cat([G.gather_rows(hp, row),
                                   G.gather_rows(hp, col),
                                   G.linear(rbf, params.embed_rbf)], dim=-1),
                        params.embed_msg)) * emask[:, None]

    # triplet geometry: angle between in-edge and out-edge directions
    ti, to, tmask = _triplet_ends(batch, E)
    cos_a = (-G.gather_rows(dirs, ti) * G.gather_rows(dirs, to)).sum(-1) \
        .clamp(-1.0, 1.0)
    angle = torch.arccos(cos_a)
    sbf = (G.angular_basis(angle, cfg.n_spherical)[:, :, None]
           * G.radial_basis(G.gather_rows(dist, ti), cfg.n_radial,
                            cfg.cutoff)[:, None, :]
           ).reshape(-1, cfg.n_spherical * cfg.n_radial) * tmask[:, None]

    node_out = C.new_zeros(h, (n, cfg.d_hidden), "fsdp", None)
    for bp in C.layer_slices({k: getattr(params.blocks, k) for k in BLOCK}):
        # bilinear triplet interaction (DimeNet++ down/up projection)
        m_in = G.linear(G.gather_rows(m, ti), bp["w_down"])  # [T, nbil]
        tmsg = m_in * G.linear(sbf, bp["w_sbf"])             # [T, nbil]
        agg = G.linear(G.scatter_sum(torch.where(tmask[:, None], tmsg, 0),
                                     pl["to"]), bp["w_up"])  # [E, d]
        m_new = F.silu(G.linear(m, bp["w_msg"]) + agg) * emask[:, None]
        m = m + m_new
        gate = G.linear(rbf, bp["w_rbf_gate"])               # [E, d]
        contrib = G.scatter_sum(m * gate, pl["col"])
        node_out = node_out + G.linear(
            F.silu(G.linear(contrib, bp["w_out1"])), bp["w_out2"])
    per_node = G.linear(F.silu(G.linear(node_out, params.head_w1)),
                        params.head_w2)
    energies = G.scatter_sum(per_node, pl["batch_id"])
    return energies.squeeze(1)


def loss_fn(params: DimeNet, batch: Dict[str, Any],
            cfg: DimeNetConfig) -> torch.Tensor:
    e = forward(params, batch, cfg)
    return torch.mean((e - batch["energy"]) ** 2)
