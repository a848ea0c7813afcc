"""EquiformerV2-style equivariant graph attention [arXiv:2306.12059].

The port of ``repro/models/gnn/equiformer_v2.py`` (its docstring says what
of the architecture is reproduced and what is simplified):

  * node features are irrep channels x ∈ [N, n_lm, C] with l ≤ l_max,
    only the |m| ≤ m_max components carried (eSCN),
  * per edge: gather source irreps, modulate by real-SH direction features
    and a radial basis, mix channels with per-l weights,
  * multi-head attention over incoming edges: scalar-channel scores, a
    segment softmax per destination,
  * a gated nonlinearity: l = 0 scalars gate the higher-l channels.

Edges run in chunks of ``edge_chunk``, each chunk's two passes (softmax
max; then the unnormalised aggregate and the denominators) under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``ed scans.
The max is ``scatter_reduce(amax)`` from -1e30; the sums go through
``segment_sum``'s kernel on one plan a chunk (live edges only).  The
``lax.scan`` over the stacked layers is a loop over their slices
(``common.layer_slices``); ``probe_unroll`` (a scan
unroll for the TPU dry-run) is not carried.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as C
from repro_torch.models.common import ParamSpec
from repro_torch.models.gnn import common as G

#: The stacked per-layer weights.
LAYER = ("w_src", "w_msg", "w_rad", "w_att_src", "w_att_dst", "w_att_rbf",
         "w_gate", "ln_g", "ln_b")


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_radial: int = 8
    d_feat: int = 16
    cutoff: float = 5.0
    dtype: Any = torch.float32
    # edges run in rematerialised chunks (two passes: softmax stats, then
    # aggregation), so [E, n_lm, d] messages never exist at once
    edge_chunk: int = 1 << 21
    # per-l channel mixing on NODES before gathering (linear, so the same
    # result with E/N fewer matmul flops), gathered activations in act_dtype
    transform_then_gather: bool = True
    act_dtype: Any = torch.bfloat16

    @property
    def lm_count(self) -> int:
        return sum(2 * min(l, self.m_max) + 1 for l in range(self.l_max + 1))


def lm_maps(cfg: EquiformerV2Config,
            device: torch.device | str = "cpu"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full-SH index per kept component [n_lm], l per kept component)."""
    keep: List[int] = []
    l_of: List[int] = []
    for l in range(cfg.l_max + 1):
        for m in range(-l, l + 1):
            if abs(m) <= cfg.m_max:
                keep.append(l * l + l + m)
                l_of.append(l)
    return (torch.tensor(keep, dtype=torch.long, device=device),
            torch.tensor(l_of, dtype=torch.long, device=device))


def param_specs(cfg: EquiformerV2Config) -> Dict[str, Any]:
    S = ParamSpec
    L, d, H = cfg.n_layers, cfg.d_hidden, cfg.n_heads
    n_l = cfg.l_max + 1
    return {
        "embed_node": S((cfg.d_feat, d), cfg.dtype),
        "layers": {
            # per-l channel mixers (SO(2)-conv block-diagonal pattern)
            "w_src": S((L, n_l, d, d), cfg.dtype),
            "w_msg": S((L, n_l, d, d), cfg.dtype),
            "w_rad": S((L, cfg.n_radial, n_l * d), cfg.dtype),
            # attention scores from scalar channels
            "w_att_src": S((L, d, H), cfg.dtype),
            "w_att_dst": S((L, d, H), cfg.dtype),
            "w_att_rbf": S((L, cfg.n_radial, H), cfg.dtype),
            # gated nonlinearity
            "w_gate": S((L, d, n_l * d), cfg.dtype),
            "ln_g": S((L, d), cfg.dtype, init="ones"),
            "ln_b": S((L, d), cfg.dtype, init="zeros"),
        },
        "head_w1": S((d, d), cfg.dtype),
        "head_w2": S((d, 1), cfg.dtype),
    }


class EquiformerV2(C.TreeModel):
    """EquiformerV2's weights and its config (``common.TreeModel``)."""

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return forward(self, batch, self.cfg)


#: The family's module class (what ``train.step`` builds).
MODEL = EquiformerV2


def _chunks(batch: Dict[str, Any], cfg: EquiformerV2Config):
    """row and col padded with the sentinel n to whole chunks:
    ([n_chunks, ec], [n_chunks, ec])."""
    n = batch["node_feat"].shape[0]
    row, col = batch["row"].long(), batch["col"].long()
    E = row.shape[0]
    ec = min(cfg.edge_chunk, E)
    n_chunks = (E + ec - 1) // ec
    pad = n_chunks * ec - E

    def pad_e(a):
        return torch.cat([a, a.new_full((pad,), n)]) if pad else a

    return pad_e(row).reshape(n_chunks, ec), pad_e(col).reshape(n_chunks, ec)


def plans(batch: Dict[str, Any], cfg: EquiformerV2Config) -> Dict[str, Any]:
    """The forward's scatter plans (host packing, from the batch's host
    copies where it has them): each edge chunk's ``col`` (live edges) and
    ``batch_id``."""
    n, dev = batch["node_feat"].shape[0], batch["node_feat"].device
    hb = G.host_view(batch)
    row_c, col_c = _chunks(hb, cfg)
    return {"chunks": [G.scatter_plan(c, n, r < n, device=dev)
                       for r, c in zip(row_c, col_c)],
            "batch_id": G.scatter_plan(hb["batch_id"], batch["n_graphs"],
                                       device=dev)}


def forward(params: EquiformerV2, batch: Dict[str, Any],
            cfg: EquiformerV2Config) -> torch.Tensor:
    n = batch["node_feat"].shape[0]
    dev = batch["node_feat"].device
    keep_idx, l_of = lm_maps(cfg, dev)
    n_lm = cfg.lm_count
    d, H = cfg.d_hidden, cfg.n_heads
    row_c, col_c = _chunks(batch, cfg)
    pl = plans(batch, cfg)

    posp = torch.cat([batch["pos"].to(cfg.dtype),
                      torch.zeros((1, 3), dtype=cfg.dtype, device=dev)])
    h0 = batch["node_feat"].to(cfg.dtype) @ params.embed_node   # [N, d]
    x = torch.cat([h0[:, None, :], h0.new_zeros((n, n_lm - 1, d))], dim=1)

    def edge_geometry(rows, cols):
        emask = rows < n
        vec = posp[cols] - posp[rows]
        dist = torch.linalg.vector_norm(vec + (~emask[:, None]) * 1.0,
                                        dim=-1)
        dirs = vec / torch.clamp(dist[:, None], min=1e-6)
        rbf = G.radial_basis(dist, cfg.n_radial, cfg.cutoff) \
            * emask[:, None]
        sh = G.spherical_harmonics_dirs(dirs, cfg.l_max)[:, keep_idx]
        return emask, rbf, sh

    for lp in C.layer_slices({k: getattr(params.layers, k) for k in LAYER}):
        xp = torch.cat([x, x.new_zeros((1, n_lm, d))])
        w_src = lp["w_src"][l_of]
        if cfg.transform_then_gather:
            # node-side per-l mixing (linear, so it commutes with the
            # gather) and node-side score features
            yp = torch.einsum("nlc,lcd->nld", xp, w_src).to(cfg.act_dtype)
            a_src = xp[:, 0, :] @ lp["w_att_src"]            # [N+1, H]
            a_dst = xp[:, 0, :] @ lp["w_att_dst"]
        else:
            yp = a_src = a_dst = None

        def chunk_score(rows, cols, emask, rbf, xp=xp, lp=lp, a_src=a_src,
                        a_dst=a_dst):
            if cfg.transform_then_gather:
                score = a_src[rows] + a_dst[cols] + rbf @ lp["w_att_rbf"]
            else:
                s0_src, s0_dst = xp[rows][:, 0, :], xp[cols][:, 0, :]
                score = (s0_src @ lp["w_att_src"]
                         + s0_dst @ lp["w_att_dst"]
                         + rbf @ lp["w_att_rbf"])
            return torch.where(emask[:, None], score, -1e30)

        # pass 1: segment-softmax stats (max) over incoming edges, chunked
        def p1(smax, rows, cols, chunk_score=chunk_score):
            emask, rbf, _ = edge_geometry(rows, cols)
            score = chunk_score(rows, cols, emask, rbf)
            return smax.scatter_reduce(0, cols[:, None].expand(-1, H), score,
                                       "amax", include_self=True)

        smax = torch.full((n + 1, H), -1e30, dtype=torch.float32, device=dev)
        for rows, cols in zip(row_c, col_c):
            smax = checkpoint(p1, smax, rows, cols, use_reentrant=False)
        smax = torch.clamp(smax, min=-1e30)

        # pass 2: unnormalised aggregate + denominators, chunked, remat'd
        def p2(den, agg, rows, cols, plan, chunk_score=chunk_score, yp=yp,
               xp=xp, w_src=w_src, lp=lp, smax=smax):
            emask, rbf, sh = edge_geometry(rows, cols)
            score = chunk_score(rows, cols, emask, rbf)
            p = torch.exp(score - smax[cols]) * emask[:, None]   # [ec, H]
            den = den + G.scatter_sum(p, plan)
            rad = (rbf @ lp["w_rad"]).reshape(-1, cfg.l_max + 1, d)[:, l_of]
            if cfg.transform_then_gather:
                msg = yp[rows].float()                       # [ec, n_lm, d]
            else:
                msg = torch.einsum("elc,lcd->eld", xp[rows], w_src)
            msg = msg * sh[:, :, None] * rad
            msg = msg.reshape(-1, n_lm, H, d // H) * p[:, None, :, None]
            agg = agg + G.scatter_sum(msg.reshape(-1, n_lm * d), plan)
            return den, agg

        den = torch.full((n, H), 1e-9, dtype=torch.float32, device=dev)
        agg = torch.zeros((n, n_lm * d), dtype=torch.float32, device=dev)
        for rows, cols, plan in zip(row_c, col_c, pl["chunks"]):
            den, agg = checkpoint(p2, den, agg, rows, cols, plan,
                                  use_reentrant=False)
        alpha_den = torch.repeat_interleave(den, d // H, dim=1)   # [n, d]
        agg = (agg.reshape(n, n_lm, d) / alpha_den[:, None, :]).to(x.dtype)
        upd = torch.einsum("nlc,lcd->nld", agg, lp["w_msg"][l_of])
        # gated nonlinearity: scalars gate everything
        s = G.layer_norm(upd[:, 0, :], lp["ln_g"], lp["ln_b"])
        gate = torch.sigmoid(s @ lp["w_gate"]).reshape(n, cfg.l_max + 1, d)
        x = x + upd * gate[:, l_of, :]
    per_node = F.silu(x[:, 0, :] @ params.head_w1) @ params.head_w2
    energies = G.scatter_sum(per_node, pl["batch_id"])
    return energies.squeeze(1)


def loss_fn(params: EquiformerV2, batch: Dict[str, Any],
            cfg: EquiformerV2Config) -> torch.Tensor:
    e = forward(params, batch, cfg)
    return torch.mean((e - batch["energy"]) ** 2)
