"""DLRM (Naumov et al. [arXiv:1906.00091]) — MLPerf benchmark config.

  dense features → bottom MLP ┐
                              ├ dot-interaction → top MLP → CTR logit
  26 sparse features → E-bags ┘

The port of ``repro/models/dlrm.py``.  Each single-hot lookup goes through
:func:`repro_torch.kernels.embedding_bag.ops.embedding_bag` as a bag of
one row with weight 1.0: on CUDA tensors that launches the hand-written
``embedding_bag`` kernel (one launch a table a forward), on CPU tensors
it takes the kernel's plain version.  With one term and a weight of 1.0
the kernel's float32 sum is the row itself, so either way the lookup
equals the reference's ``jnp.take`` bit for bit.

:class:`DLRM` is an ``nn.Module`` whose ``state_dict`` keys are the
reference's tree paths (``tables.t0``, ``bot_w0``, ``top_b4``);
:func:`forward`, :func:`loss_fn`, :func:`serve_step` and
:func:`retrieval_step` keep the reference's signatures, with the module
in place of the parameter tree.  Built with ``trainable=True`` its
weights take gradients: ``loss_fn`` runs under autograd, the tables'
gradients through the ``embedding_bag`` op's backward (the backward
kernel on CUDA tensors, one launch a table a step).  Tables are not row-sharded: one card
holds them (the reference's partition specs have no meaning here), but
their rows are padded as the reference pads them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.embedding_bag import ops as EB
from repro_torch.models import common as C
from repro_torch.models.common import ParamSpec


# MLPerf DLRM (Criteo 1TB) per-feature vocabulary sizes.
MLPERF_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """The reference's config less its ``interaction`` field, which
    nothing reads: the interaction is always the dot product."""
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    vocabs: Tuple[int, ...] = MLPERF_VOCABS
    dtype: Any = torch.float32

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_in(self) -> int:
        return self.embed_dim + self.n_interactions


def param_specs(cfg: DLRMConfig) -> Dict[str, Any]:
    S = ParamSpec
    specs: Dict[str, Any] = {"tables": {}}
    for i, v in enumerate(cfg.vocabs):
        # the reference pads the tables it row-shards (v >= 4096) to a
        # multiple of 512 rows; the extra rows are never indexed
        if v >= 4096:
            v = ((v + 511) // 512) * 512
        specs["tables"][f"t{i}"] = S((v, cfg.embed_dim), cfg.dtype,
                                     scale=1.0 / cfg.embed_dim)
    for j, (a, b) in enumerate(zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:])):
        specs[f"bot_w{j}"] = S((a, b), cfg.dtype)
        specs[f"bot_b{j}"] = S((b,), cfg.dtype, init="zeros")
    # top_mlp entries are all layer widths; input = bottom-out ++ interactions
    dims = (cfg.top_in,) + cfg.top_mlp
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"top_w{j}"] = S((a, b), cfg.dtype)
        specs[f"top_b{j}"] = S((b,), cfg.dtype, init="zeros")
    return specs


class DLRM(C.TreeModel):
    """DLRM's weights and its config (``common.TreeModel``)."""

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return forward(self, batch, self.cfg)


#: The family's module class (what ``train.step`` builds).
MODEL = DLRM


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  host_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Single-hot bag == gather; [B] int32 → [B, dim], as a bag of one row
    through the ``embedding_bag`` op (the kernel on CUDA tensors).  The
    reference's ``jnp.take``: an id in [-V, -1] wraps (the op wraps it),
    and one outside [-V, V), V the padded ``table.shape[0]``, gives a NaN
    row, here by the weight NaN (NaN x any row); every other weight is
    1.0, so in-range rows come back exact.  The table's gradient is
    ``take``'s: the op's backward drops such an id before it reads the
    weight, so the NaN stays in the forward.  ``host_idx``, a CPU copy
    of ``idx`` (a batch's ``"host"`` ids), goes to the op's work formula
    as a view: no host op of it is counted as the device's work."""
    rows = idx.contiguous()[:, None]
    n = table.shape[0]
    wgt = torch.where((rows >= -n) & (rows < n), 1.0, float("nan"))
    return EB.embedding_bag(table, rows, wgt.to(torch.float32),
                            None if host_idx is None else host_idx[:, None])


def _mlp(params: DLRM, prefix: str, x: torch.Tensor, n: int) -> torch.Tensor:
    for j in range(n):
        x = x @ getattr(params, f"{prefix}_w{j}") \
            + getattr(params, f"{prefix}_b{j}")
        if j < n - 1:
            x = C.relu(x)
    return x


def forward(params: DLRM, batch: Dict[str, torch.Tensor],
            cfg: DLRMConfig) -> torch.Tensor:
    """batch: dense [B, 13] f32, sparse [B, 26] int32 → logits [B]; a
    host copy of sparse under ``batch["host"]`` goes to the lookups' work
    formula."""
    dense, sparse = batch["dense"], batch["sparse"]
    host = batch.get("host", {}).get("sparse")
    d = _mlp(params, "bot", dense.to(cfg.dtype), len(cfg.bot_mlp) - 1)
    d = C.relu(d)                                     # [B, dim]
    embs = [
        embedding_bag(getattr(params.tables, f"t{i}"), sparse[:, i],
                      None if host is None else host[:, i])
        for i in range(cfg.n_sparse)
    ]
    feats = torch.stack([d] + embs, dim=1)                # [B, F, dim]
    z = torch.einsum("bfd,bgd->bfg", feats, feats)        # dot interaction
    iu = torch.triu_indices(feats.shape[1], feats.shape[1], offset=1,
                            device=feats.device)
    inter = z[:, iu[0], iu[1]]                            # [B, F(F-1)/2]
    top_in = torch.cat([d, inter], dim=-1)
    logit = _mlp(params, "top", top_in, len(cfg.top_mlp))
    return logit.squeeze(1)


def loss_fn(params: DLRM, batch: Dict[str, torch.Tensor],
            cfg: DLRMConfig) -> torch.Tensor:
    logit = forward(params, batch, cfg)
    y = batch["labels"].float()
    return torch.mean(
        torch.clamp(logit, min=0) - logit * y
        + torch.log1p(torch.exp(-torch.abs(logit)))
    )


def serve_step(params: DLRM, batch: Dict[str, torch.Tensor],
               cfg: DLRMConfig) -> torch.Tensor:
    return torch.sigmoid(forward(params, batch, cfg))


def retrieval_step(params: DLRM, batch: Dict[str, torch.Tensor],
                   cfg: DLRMConfig) -> torch.Tensor:
    """Score 1 query against n_candidates: candidate item embeddings come
    from table 0 rows (the big item table); one batched matvec."""
    q_dense = batch["dense"]                      # [1, 13]
    d = _mlp(params, "bot", q_dense.to(cfg.dtype), len(cfg.bot_mlp) - 1)
    d = C.relu(d)                             # [1, dim]
    cand = embedding_bag(params.tables.t0, batch["candidates"][0])
    scale = torch.sqrt(torch.tensor(float(cfg.embed_dim), device=d.device))
    return (cand @ d[0]) / scale                  # [n_candidates]
