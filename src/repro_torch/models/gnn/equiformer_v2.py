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

On a mesh (the sharded count) the reference's four ``shard_hint`` calls
lay the node irreps and the accumulators' rows over the fsdp axes (the
port's accumulators hold n rows, which the axes divide; the reference's
n + 1 replicate), each edge chunk lies over every axis
(:func:`chunk_layout`), and its plan is packed from this rank's block of
it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import is_dtensor
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


def param_specs(cfg: EquiformerV2Config, fsdp=("data",)) -> Dict[str, Any]:
    S = ParamSpec
    L, d, H = cfg.n_layers, cfg.d_hidden, cfg.n_heads
    n_l = cfg.l_max + 1
    return {
        "embed_node": S((cfg.d_feat, d), cfg.dtype, (None, "model")),
        "layers": {
            # per-l channel mixers (SO(2)-conv block-diagonal pattern)
            "w_src": S((L, n_l, d, d), cfg.dtype, (None, None, None, "model")),
            "w_msg": S((L, n_l, d, d), cfg.dtype, (None, None, "model", None)),
            "w_rad": S((L, cfg.n_radial, n_l * d), cfg.dtype,
                       (None, None, None)),
            # attention scores from scalar channels
            "w_att_src": S((L, d, H), cfg.dtype, (None, None, None)),
            "w_att_dst": S((L, d, H), cfg.dtype, (None, None, None)),
            "w_att_rbf": S((L, cfg.n_radial, H), cfg.dtype,
                           (None, None, None)),
            # gated nonlinearity
            "w_gate": S((L, d, n_l * d), cfg.dtype, (None, None, None)),
            "ln_g": S((L, d), cfg.dtype, (None, None), init="ones"),
            "ln_b": S((L, d), cfg.dtype, (None, None), init="zeros"),
        },
        "head_w1": S((d, d), cfg.dtype, (None, "model")),
        "head_w2": S((d, 1), cfg.dtype, ("model", None)),
    }


class EquiformerV2(C.TreeModel):
    """EquiformerV2's weights and its config (``common.TreeModel``)."""

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return forward(self, batch, self.cfg)


#: The family's module class (what ``train.step`` builds).
MODEL = EquiformerV2


def _chunks(batch: Dict[str, Any], cfg: EquiformerV2Config):
    """row and col padded with the sentinel n to whole chunks:
    ([n_chunks, ec], [n_chunks, ec]); of DTensors (on a mesh), two lists
    of n_chunks chunks, each laid out as :func:`chunk_layout` says."""
    n = batch["node_feat"].shape[0]
    row, col = batch["row"].long(), batch["col"].long()
    E = row.shape[0]
    ec = min(cfg.edge_chunk, E)
    n_chunks = (E + ec - 1) // ec
    pad = n_chunks * ec - E
    if is_dtensor(row):
        return (_laid_out_chunks(row, n, ec, n_chunks),
                _laid_out_chunks(col, n, ec, n_chunks))

    def pad_e(a):
        return torch.cat([a, a.new_full((pad,), n)]) if pad else a

    return pad_e(row).reshape(n_chunks, ec), pad_e(col).reshape(n_chunks, ec)


def chunk_layout(mesh, ec: int) -> G.Layout:
    """The layout of one edge chunk of ``ec`` edges on ``mesh``: over
    every axis (fsdp + ``model``, as the edges), sanitised.  The
    reference's program reshapes an [E] sharded so into [n_chunks, ec]
    and scans the chunks, each chunk's edges spread over the devices."""
    return G.Layout(mesh, C.placements(
        (ec,), (tuple(mesh.mesh_dim_names),), mesh))


def _laid_out_chunks(a, fill: int, ec: int, n_chunks: int) -> list:
    """An edge array (a DTensor) cut into chunks of ``ec`` (the last
    padded with ``fill``), each laid out by :func:`chunk_layout`.  One
    chunk that is the array keeps it as it is; otherwise the ids are
    all-gathered and each rank takes its block of every chunk."""
    lay = chunk_layout(a.device_mesh, ec)
    if n_chunks * ec == a.shape[0] == ec and (
            tuple(a.placements) == lay.placements):
        return [a]
    whole = C.replicated(a)
    pad = n_chunks * ec - whole.shape[0]
    if pad:
        whole = torch.cat([whole, whole.new_full((pad,), fill)])
    return [C.local_dtensor(c, lay.placements, lay.device_mesh)
            for c in whole.reshape(n_chunks, ec)]


def plans(batch: Dict[str, Any], cfg: EquiformerV2Config) -> Dict[str, Any]:
    """The forward's scatter plans (host packing, from the batch's host
    copies where it has them): each edge chunk's ``col`` (live edges) and
    ``batch_id``.  On a mesh each chunk's plan is packed from this rank's
    block of the chunk, cut from the whole host arrays
    (``batch["host_whole"]``), and sums onto node rows over the fsdp
    axes; the energies' is replicated."""
    n, dev = batch["node_feat"].shape[0], batch["node_feat"].device
    hb = G.host_view(batch)
    bid = G.scatter_plan(hb["batch_id"], batch["n_graphs"], device=dev,
                         like=batch["batch_id"])
    if not is_dtensor(batch["row"]):
        row_c, col_c = _chunks(hb, cfg)
        return {"chunks": [G.scatter_plan(c, n, r < n, device=dev)
                           for r, c in zip(row_c, col_c)],
                "batch_id": bid}
    row_c, col_c = _chunks({**batch, **batch["host_whole"]}, cfg)
    lay = chunk_layout(batch["row"].device_mesh, row_c.shape[1])
    cut = C.block_slices(tuple(row_c.shape[1:]), lay.placements,
                         lay.device_mesh)
    return {"chunks": [G.scatter_plan(c[cut], n, r[cut] < n, device=dev,
                                      like=lay, rows=("fsdp",))
                       for r, c in zip(row_c, col_c)],
            "batch_id": bid}


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
    h0 = G.linear(batch["node_feat"].to(cfg.dtype), params.embed_node)
    x = torch.cat([h0[:, None, :],
                   C.new_zeros(h0, (n, n_lm - 1, d), "fsdp", None, None)],
                  dim=1)
    x = C.shard_hint(x, "fsdp", None, None)

    def edge_geometry(rows, cols):
        emask = rows < n
        vec = G.gather_rows(posp, cols) - G.gather_rows(posp, rows)
        dist = torch.linalg.vector_norm(vec + (~emask[:, None]) * 1.0,
                                        dim=-1)
        dirs = vec / torch.clamp(dist[:, None], min=1e-6)
        rbf = G.radial_basis(dist, cfg.n_radial, cfg.cutoff) \
            * emask[:, None]
        sh = G.take(G.spherical_harmonics_dirs(dirs, cfg.l_max), keep_idx, 1)
        return emask, rbf, sh

    for lp in C.layer_slices({k: getattr(params.layers, k) for k in LAYER}):
        xp = G.pad_row(x)
        w_src = G.take(lp["w_src"], l_of, 0)
        if cfg.transform_then_gather:
            # node-side per-l mixing (linear, so it commutes with the
            # gather) and node-side score features
            # (on a mesh gathered whole once a layer, not once a chunk)
            yp = G.whole(C.einsum("nlc,lcd->nld", xp, w_src)
                         .to(cfg.act_dtype))
            a_src = G.linear(xp[:, 0, :], lp["w_att_src"])   # [N+1, H]
            a_dst = G.linear(xp[:, 0, :], lp["w_att_dst"])
        else:
            yp = a_src = a_dst = None

        def chunk_score(rows, cols, emask, rbf, xp=xp, lp=lp, a_src=a_src,
                        a_dst=a_dst):
            if cfg.transform_then_gather:
                score = (G.gather_rows(a_src, rows)
                         + G.gather_rows(a_dst, cols)
                         + G.linear(rbf, lp["w_att_rbf"]))
            else:
                s0_src = G.gather_rows(xp, rows)[:, 0, :]
                s0_dst = G.gather_rows(xp, cols)[:, 0, :]
                score = (G.linear(s0_src, lp["w_att_src"])
                         + G.linear(s0_dst, lp["w_att_dst"])
                         + G.linear(rbf, lp["w_att_rbf"]))
            return torch.where(emask[:, None], score, -1e30)

        # pass 1: segment-softmax stats (max) over incoming edges, chunked
        def p1(smax, rows, cols, chunk_score=chunk_score):
            emask, rbf, _ = edge_geometry(rows, cols)
            score = chunk_score(rows, cols, emask, rbf)
            return G.scatter_amax(smax, cols, score)

        smax = torch.full((n + 1, H), -1e30, dtype=torch.float32, device=dev)
        for rows, cols in zip(row_c, col_c):
            smax = checkpoint(p1, smax, rows, cols, use_reentrant=False)
        smax = torch.clamp(smax, min=-1e30)

        # pass 2: unnormalised aggregate + denominators, chunked, remat'd
        def p2(den, agg, rows, cols, plan, chunk_score=chunk_score, yp=yp,
               xp=xp, w_src=w_src, lp=lp, smax=smax):
            emask, rbf, sh = edge_geometry(rows, cols)
            score = chunk_score(rows, cols, emask, rbf)
            p = torch.exp(score - G.gather_rows(smax, cols)) \
                * emask[:, None]                              # [ec, H]
            den = den + G.scatter_sum(p, plan)
            rad = G.take(G.linear(rbf, lp["w_rad"]).reshape(
                -1, cfg.l_max + 1, d), l_of, 1)
            if cfg.transform_then_gather:
                msg = G.gather_rows(yp, rows).float()        # [ec, n_lm, d]
            else:
                msg = C.einsum("elc,lcd->eld", G.gather_rows(xp, rows), w_src)
            msg = msg * sh[:, :, None] * rad
            msg = msg.reshape(-1, n_lm, H, d // H) * p[:, None, :, None]
            agg = agg + G.scatter_sum(msg.reshape(-1, n_lm * d), plan)
            return den, agg

        # the accumulators' rows over the fsdp axes (the reference hints
        # [n + 1] rows so, which no axis divides; the port's have n)
        den = C.shard_hint(C.full(x, (n, H), 1e-9, torch.float32, "fsdp",
                                  None), "fsdp", None)
        agg = C.shard_hint(C.zeros(x, (n, n_lm * d), torch.float32, "fsdp",
                                   None), "fsdp", None)
        for rows, cols, plan in zip(row_c, col_c, pl["chunks"]):
            den, agg = checkpoint(p2, den, agg, rows, cols, plan,
                                  use_reentrant=False)
        alpha_den = G.repeat_cols(den, d // H)                    # [n, d]
        agg = (agg.reshape(n, n_lm, d) / alpha_den[:, None, :]).to(x.dtype)
        upd = C.einsum("nlc,lcd->nld", agg, G.take(lp["w_msg"], l_of, 0))
        # gated nonlinearity: scalars gate everything
        s = G.layer_norm(upd[:, 0, :], lp["ln_g"], lp["ln_b"])
        gate = torch.sigmoid(G.linear(s, lp["w_gate"])).reshape(
            n, cfg.l_max + 1, d)
        x = C.shard_hint(x + upd * G.take(gate, l_of, 1), "fsdp", None, None)
    per_node = G.linear(F.silu(G.linear(x[:, 0, :], params.head_w1)),
                        params.head_w2)
    energies = G.scatter_sum(per_node, pl["batch_id"])
    return energies.squeeze(1)


def loss_fn(params: EquiformerV2, batch: Dict[str, Any],
            cfg: EquiformerV2Config) -> torch.Tensor:
    e = forward(params, batch, cfg)
    return torch.mean((e - batch["energy"]) ** 2)
