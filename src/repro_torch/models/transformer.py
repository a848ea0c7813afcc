"""Decoder-only LM family: dense + MoE, GQA, qk-norm, RoPE, local:global.

The port of ``repro/models/transformer.py``: one configurable block covers
the reference's five LM archs (GQA with an explicit d_head, optional
per-head qk RMS-norm, gemma3's sliding-window : global interleave, and
the top-k routed MoE FFN with capacity-bucketed dispatch).
:class:`Transformer` is an ``nn.Module`` whose ``state_dict`` keys are
the reference's tree paths (``embed``, ``attn.wq``, ``ffn.w_down``,
``final_norm``); per-layer weights stay stacked on a leading layer axis,
as the reference's scan reads them.

:func:`serve_step` decodes one token against a KV cache.  It writes the
new keys and values into the cache in place (the reference's
``dynamic_update_slice``, start clamped the same way) and returns the
same cache tensors.  The cache-free :func:`forward` (flash attention,
each layer under ``torch.utils.checkpoint`` when ``cfg.remat``) serves
:func:`loss_fn` (the chunked LM-head loss plus the MoE aux loss) and
:func:`prefill_step`.  Token ids read the embedding as the reference's
``embed[tokens]`` does: a negative id wraps once, then ids are clamped
into the vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.embedding_bag.ref import table_rows
from repro_torch.models import common as C


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, less ``probe_unroll`` (it unrolls the
    reference's scans for the TPU dry-run's cost analysis; the port has no
    scan)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE ( d_ff is the per-expert hidden when moe_experts > 0 )
    moe_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # attention flavour
    qk_norm: bool = False
    local_window: int = 0     # sliding-window size (0 = full attention)
    global_every: int = 0     # every k-th layer is global (gemma3: 6)
    rope_theta: float = 10_000.0
    # numerics / scheduling
    dtype: Any = torch.bfloat16
    attn_chunk: int = 1024
    loss_chunks: int = 8
    remat: bool = True
    aux_loss_coef: float = 0.01

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def n_params(self) -> int:
        a = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        a += self.n_heads * self.d_head * self.d_model
        if self.is_moe:
            f = self.moe_experts * 3 * self.d_model * self.d_ff
            f += self.d_model * self.moe_experts
        else:
            f = 3 * self.d_model * self.d_ff
        return self.n_layers * (a + f) + self.vocab * self.d_model

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        a = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        a += self.n_heads * self.d_head * self.d_model
        if self.is_moe:
            f = self.moe_top_k * 3 * self.d_model * self.d_ff
            f += self.d_model * self.moe_experts
        else:
            f = 3 * self.d_model * self.d_ff
        return self.n_layers * (a + f) + self.vocab * self.d_model


# --------------------------------------------------------------------- #
# parameter specs
# --------------------------------------------------------------------- #
def param_specs(cfg: TransformerConfig, fsdp=("data",)) -> Dict[str, Any]:
    """The weights' specs, each with the reference's partition spec over
    the production mesh (``fsdp``: the axes that shard the weights' FSDP
    dim, ``("data",)`` or ``("pod", "data")``)."""
    L, D, H, Hkv, dh, F, V = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
        cfg.d_ff, cfg.vocab,
    )
    f = tuple(fsdp)
    S = C.ParamSpec
    dt = cfg.dtype
    f32 = torch.float32
    specs: Dict[str, Any] = {
        "embed": S((V, D), dt, ("model", f)),
        "final_norm": S((D,), f32, (None,), init="zeros"),
        "attn": {
            "norm": S((L, D), f32, (None, None), init="zeros"),
            "wq": S((L, D, H * dh), dt, (None, f, "model")),
            "wk": S((L, D, Hkv * dh), dt, (None, f, None)),
            "wv": S((L, D, Hkv * dh), dt, (None, f, None)),
            "wo": S((L, H * dh, D), dt, (None, "model", f)),
        },
    }
    if cfg.qk_norm:
        specs["attn"]["q_norm"] = S((L, dh), f32, (None, None), init="zeros")
        specs["attn"]["k_norm"] = S((L, dh), f32, (None, None), init="zeros")
    if cfg.is_moe:
        E = cfg.moe_experts
        specs["ffn"] = {
            "norm": S((L, D), f32, (None, None), init="zeros"),
            "router": S((L, D, E), f32, (None, f, None)),
            "w_gate": S((L, E, D, F), dt, (None, "model", f, None)),
            "w_up": S((L, E, D, F), dt, (None, "model", f, None)),
            "w_down": S((L, E, F, D), dt, (None, "model", None, f)),
        }
    else:
        specs["ffn"] = {
            "norm": S((L, D), f32, (None, None), init="zeros"),
            "w_gate": S((L, D, F), dt, (None, f, "model")),
            "w_up": S((L, D, F), dt, (None, f, "model")),
            "w_down": S((L, F, D), dt, (None, "model", f)),
        }
    return specs


class Transformer(C.TreeModel):
    """The LM's weights and its config (``common.TreeModel``)."""


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #
def _layer_window(cfg: TransformerConfig, layer_idx: int) -> Optional[int]:
    """Per-layer sliding window; None if the config is all-global."""
    if not cfg.local_window:
        return None
    if not cfg.global_every:
        return cfg.local_window
    is_global = (layer_idx % cfg.global_every) == (cfg.global_every - 1)
    return 2**30 if is_global else cfg.local_window


def _layers(group: nn.Module) -> list[Dict[str, torch.Tensor]]:
    """Every layer's slices of a stacked weight group (``attn`` / ``ffn``),
    cut once a forward (``common.layer_slices``)."""
    return C.layer_slices(dict(group.named_parameters()))


def _attention(x, lp, cfg: TransformerConfig, layer_idx: int, positions,
               kv_cache=None, cache_len: Optional[int] = None):
    B, T, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = C.rms_norm(x, lp["norm"])
    q = C.einsum("btd,dh->bth", h, lp["wq"].to(h.dtype))
    k = C.einsum("btd,dh->bth", h, lp["wk"].to(h.dtype))
    v = C.einsum("btd,dh->bth", h, lp["wv"].to(h.dtype))
    q = C.split_heads(q, H, dh)
    k = C.split_heads(k, Hkv, dh)
    v = C.split_heads(v, Hkv, dh)
    if cfg.qk_norm:
        q = C.rms_norm(q, lp["q_norm"])
        k = C.rms_norm(k, lp["k_norm"])
    q = C.rope(q, positions, cfg.rope_theta)
    k = C.rope(k, positions, cfg.rope_theta)
    window = _layer_window(cfg, layer_idx)

    if kv_cache is None:
        o = C.flash_attention(q, k, v, window, causal=True,
                              chunk=cfg.attn_chunk)
        new_cache = None
    else:
        kc, vc = kv_cache
        # lax.dynamic_update_slice clamps its start so the update fits
        pos0 = min(max(cache_len, 0), kc.shape[1] - T)
        # sharded: the new rows laid out as the cache (the reference's
        # cache in_shardings), the query too
        q, k, v = (C.laid_out_as(t, kc) for t in (q, k, v))
        C.write_rows(kc, k, pos0)
        C.write_rows(vc, v, pos0)
        o = C.decode_attention(q, kc, vc, cache_len + T, window=window)
        o = C.shard_hint(o, "fsdp", None, None, None)
        new_cache = (kc, vc)
    o = o.reshape(B, T, H * dh)
    out = C.einsum("bth,hd->btd", o, lp["wo"].to(o.dtype))
    return x + out, new_cache


def _dense_ffn(x, lp):
    h = C.rms_norm(x, lp["norm"])
    return x + C.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _dispatch(flat_e: torch.Tensor, E: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, slot) of each assignment (expert ids ``flat_e`` [NA]):
    its rank within its expert by a stable sort (``jnp.argsort`` is
    stable; which assignments overflow ``cap`` depends on it), kept when
    the rank is under ``cap``, in slot ``expert * cap + rank``, else in
    the overflow slot ``E * cap``."""
    ar = torch.arange(flat_e.shape[0], device=flat_e.device)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e,
                                torch.arange(E, device=flat_e.device))
    rank = torch.empty_like(ar)
    rank[order] = ar - starts[sorted_e]
    keep = rank < cap
    return keep, torch.where(keep, flat_e * cap + rank, E * cap)


def _moe_ffn(x, lp, cfg: TransformerConfig):
    """Top-k routed MoE with static capacity (sort + scatter dispatch);
    returns (x + y, the Switch-style aux load-balance loss)."""
    B, T, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    N = B * T
    # sharded: the tokens over the fsdp axes alone (the sequence-parallel
    # residual gathered), the layout of the dispatch's tokens and of the
    # combine's hints; [B, T] flattened with T sharded is refused (or a
    # strided shard, by torch's version)
    h = C.shard_hint(C.rms_norm(x, lp["norm"]), "fsdp", None, None)
    hf = h.reshape(N, D)
    logits = C.einsum("nd,de->ne", hf.float(), lp["router"])
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower index; torch.topk does not
    # promise an order among ties (a trained router rarely has exact ones)
    gate, idx = torch.topk(probs, K, dim=-1)          # [N, K], sorted
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # the routing's integer bookkeeping (the load count, the sort by
    # expert and the capacity ranks) runs on every device over all the
    # assignments, as GSPMD partitions a sort along its sharded dim
    idx = C.replicated(idx)

    # aux load-balance loss (Switch-style)
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1),
        torch.full((N * K,), 1.0 / (N * K), device=x.device))
    aux = cfg.aux_loss_coef * E * torch.sum(me * ce)

    NA = N * K
    cap = int(max(1, round(NA / E * cfg.capacity_factor)))
    keep, slot = _dispatch(idx.reshape(NA), E, cap)
    if C.is_dtensor(hf):
        buf = C.sharded_rules().moe_dispatch(hf, keep, slot, E, cap, K)
    else:
        token_of = torch.arange(NA, device=x.device) // K
        src = torch.where(keep[:, None], hf[token_of], 0).to(h.dtype)
        buf = torch.zeros((E * cap + 1, D), dtype=h.dtype, device=x.device)
        buf = buf.index_add(0, slot, src)[:E * cap].reshape(E, cap, D)
    # expert-parallel dispatch buffer: experts over `model`, capacity over
    # the fsdp axes (the token all-to-all)
    buf = C.shard_hint(buf, "model", "fsdp", None)
    # the FSDP schedule on the expert weights: gather the 2-D-sharded
    # weight shards a layer; when experts don't divide the model axis
    # (grok: E = 8 < 16) shard F / D over `model` instead
    ms = C.hint_axis_size("model") or 1
    spec = ("model", None, None) if E % max(ms, 1) == 0 else (None, None,
                                                              "model")
    wg, wu, wd = (C.shard_hint(lp[n], *spec)
                  for n in ("w_gate", "w_up", "w_down"))
    g = C.einsum("ecd,edf->ecf", buf, wg.to(buf.dtype))
    u = C.einsum("ecd,edf->ecf", buf, wu.to(buf.dtype))
    act = torch.nn.functional.silu(g.float()).to(buf.dtype) * u
    out = C.einsum("ecf,efd->ecd", act, wd.to(buf.dtype))

    out = C.shard_hint(out, "model", "fsdp", None)
    if C.is_dtensor(out):
        y_assign = C.sharded_rules().moe_combine(out, keep, slot).to(h.dtype)
    else:
        y_assign = torch.where(
            keep[:, None],
            out.reshape(E * cap, D)[torch.clamp(slot, max=E * cap - 1)], 0,
        ).to(h.dtype)
    y_assign = y_assign * gate.reshape(NA)[:, None].to(h.dtype)
    y_assign = C.shard_hint(y_assign, "fsdp", None)
    # token_of = assignment // K is contiguous: the combine is a reshape
    # and a sum over K, not a scatter
    y = y_assign.reshape(N, K, D).sum(1)
    y = C.shard_hint(y, "fsdp", None)
    # laid out as the residual once unflattened: its gradient then comes
    # back to the unflatten with the sequence whole
    return x + C.shard_hint(y.reshape(B, T, D), "fsdp", "model", None), aux


def forward(
    params: Transformer,
    tokens: torch.Tensor,         # [B, T] int
    cfg: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [L, B, S, Hkv, dh] x2
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor,
           Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (hidden [B,T,D], aux_loss summed over layers, kv_caches
    written in place — None without a cache).  Without a cache, each
    layer runs under ``torch.utils.checkpoint`` when ``cfg.remat`` and
    gradients are on (the reference's ``jax.checkpoint`` of the block)."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = C.lookup(C.gather_fsdp(params.embed),
                 table_rows(tokens, cfg.vocab)).to(cfg.dtype)
    decode = kv_caches is not None
    # a sharded lookup's masked partial sums are reduced where they are
    # made (DTensor's mask serves one reduction, and remat would reduce
    # the block's input again), to the layout the first block asks for
    x = C.shard_hint(x, "fsdp", None if decode else "model", None)
    if decode:
        kcs, vcs = kv_caches
        cache_len = int(cache_len)

    def block(x, i, attn_lp, ffn_lp):
        # Megatron-style sequence parallelism: the residual stream carried
        # between blocks (and saved by remat) is sharded over `model`
        # along the sequence dim
        if not decode:
            x = C.shard_hint(x, "fsdp", "model", None)
        # the FSDP schedule (the expert weights: _moe_ffn's hints)
        attn_lp = {k: C.gather_fsdp(w) for k, w in attn_lp.items()}
        ffn_lp = {k: w if cfg.is_moe and k.startswith("w_")
                  else C.gather_fsdp(w) for k, w in ffn_lp.items()}
        x, _ = _attention(x, attn_lp, cfg, i, positions,
                          kv_cache=(kcs[i], vcs[i]) if decode else None,
                          cache_len=cache_len)
        if cfg.is_moe:
            return _moe_ffn(x, ffn_lp, cfg)
        return _dense_ffn(x, ffn_lp), torch.zeros((), device=x.device)

    remat = cfg.remat and not decode and torch.is_grad_enabled()
    attn, ffn = _layers(params.attn), _layers(params.ffn)
    auxes = []
    for i in range(cfg.n_layers):
        if remat:
            x, aux = checkpoint(block, x, i, attn[i], ffn[i],
                                use_reentrant=False)
        else:
            x, aux = block(x, i, attn[i], ffn[i])
        auxes.append(aux)
    x = C.rms_norm(x, params.final_norm)
    return x, torch.stack(auxes).sum(), (kcs, vcs) if decode else None


# --------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------- #
def loss_fn(params: Transformer, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (``cfg.loss_chunks`` chunks) plus the MoE aux."""
    h, aux, _ = forward(params, batch["tokens"], cfg)
    xent = C.chunked_xent(h, C.gather_fsdp(params.embed), batch["labels"],
                          n_chunks=cfg.loss_chunks)
    return xent + aux


def make_kv_cache_specs(cfg: TransformerConfig, batch: int, max_seq: int,
                        fsdp=("data",), shard_seq: bool = False):
    """((shape, dtype) of the decode KV cache's keys and of its values,
    their two partition specs): the batch over ``fsdp`` and d_head over
    ``model``, or with ``shard_seq`` the sequence over ``model``."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    if shard_seq:
        pspec = (None, None, "model", None, None)
    else:
        pspec = C.canonical_pspec((None, tuple(fsdp), None, None,
                                   "model" if cfg.d_head % 8 == 0 else None))
    return ((shape, cfg.dtype), (shape, cfg.dtype)), (pspec, pspec)


def serve_step(params: Transformer, kv_caches, tokens: torch.Tensor,
               cache_len: int, cfg: TransformerConfig):
    """One decode step: tokens [B, 1] + cache → (next-token logits [B, V]
    float32, cache).  The cache is written in place and returned."""
    B = tokens.shape[0]
    cache_len = int(cache_len)
    positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                           device=tokens.device)
    h, _, new_caches = forward(
        params, tokens, cfg, positions=positions,
        kv_caches=kv_caches, cache_len=cache_len,
    )
    logits = C.einsum("btd,vd->btv", h.float(),
                          C.gather_fsdp(params.embed).float())
    return logits[:, -1], new_caches


def prefill_step(params: Transformer, tokens: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Inference prefill: the cache-free forward; returns the last
    position's logits [B, V] in float32."""
    h, _, _ = forward(params, tokens, cfg)
    return C.einsum("bd,vd->bv", h[:, -1].float(),
                        C.gather_fsdp(params.embed).float())
