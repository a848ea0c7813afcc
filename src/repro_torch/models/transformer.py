"""Decoder-only LM family: dense + MoE, GQA, qk-norm, RoPE, local:global.

The port of ``repro/models/transformer.py``'s decode path: one configurable
block covers the reference's LM archs (GQA with an explicit d_head,
optional per-head qk RMS-norm, gemma3's sliding-window : global
interleave).  :class:`Transformer` is an ``nn.Module`` whose
``state_dict`` keys are the reference's tree paths (``embed``,
``attn.wq``, ``ffn.w_down``, ``final_norm``); per-layer weights stay
stacked on a leading layer axis, as the reference's scan reads them.

:func:`serve_step` decodes one token against a KV cache.  It writes the
new keys and values into the cache in place (the reference's
``dynamic_update_slice``, start clamped the same way) and returns the
same cache tensors.

Waits for the training slice (ROADMAP Queue 1 item 5): the MoE FFN, the
cache-free forward (flash attention), ``loss_fn`` and ``prefill_step``.
They raise ``NotImplementedError``; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import common as C

#: What the parts that wait for the training slice raise.
_TRAINING_SLICE = ("waits for the training slice of the port "
                   "(ROADMAP Queue 1 item 5)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, less the knobs only its training and TPU
    paths read (``attn_chunk``, ``loss_chunks``, ``capacity_factor``,
    ``aux_loss_coef``, ``remat``, ``probe_unroll``): they come with their
    readers in the training slice."""
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
    # attention flavour
    qk_norm: bool = False
    local_window: int = 0     # sliding-window size (0 = full attention)
    global_every: int = 0     # every k-th layer is global (gemma3: 6)
    rope_theta: float = 10_000.0
    # numerics
    dtype: Any = torch.bfloat16

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
def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    L, D, H, Hkv, dh, F, V = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
        cfg.d_ff, cfg.vocab,
    )
    S = C.ParamSpec
    dt = cfg.dtype
    f32 = torch.float32
    specs: Dict[str, Any] = {
        "embed": S((V, D), dt),
        "final_norm": S((D,), f32, init="zeros"),
        "attn": {
            "norm": S((L, D), f32, init="zeros"),
            "wq": S((L, D, H * dh), dt),
            "wk": S((L, D, Hkv * dh), dt),
            "wv": S((L, D, Hkv * dh), dt),
            "wo": S((L, H * dh, D), dt),
        },
    }
    if cfg.qk_norm:
        specs["attn"]["q_norm"] = S((L, dh), f32, init="zeros")
        specs["attn"]["k_norm"] = S((L, dh), f32, init="zeros")
    if cfg.is_moe:
        E = cfg.moe_experts
        specs["ffn"] = {
            "norm": S((L, D), f32, init="zeros"),
            "router": S((L, D, E), f32),
            "w_gate": S((L, E, D, F), dt),
            "w_up": S((L, E, D, F), dt),
            "w_down": S((L, E, F, D), dt),
        }
    else:
        specs["ffn"] = {
            "norm": S((L, D), f32, init="zeros"),
            "w_gate": S((L, D, F), dt),
            "w_up": S((L, D, F), dt),
            "w_down": S((L, F, D), dt),
        }
    return specs


class Transformer(nn.Module):
    """The model's weights (a tree from :func:`common.init_params` or one
    to be filled by ``load_state_dict``) and its config."""

    def __init__(self, cfg: TransformerConfig, params: C.ParamTree):
        super().__init__()
        self.cfg = cfg
        C.register_tree(self, params)


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


def _layer(group: nn.Module, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of a stacked weight group (``attn`` / ``ffn``)."""
    return {name: p[i] for name, p in group.named_parameters()}


def _attention(x, lp, cfg: TransformerConfig, layer_idx: int, positions,
               kv_cache=None, cache_len: Optional[int] = None):
    B, T, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = C.rms_norm(x, lp["norm"])
    q = torch.einsum("btd,dh->bth", h, lp["wq"].to(h.dtype))
    k = torch.einsum("btd,dh->bth", h, lp["wk"].to(h.dtype))
    v = torch.einsum("btd,dh->bth", h, lp["wv"].to(h.dtype))
    q = q.reshape(B, T, H, dh)
    k = k.reshape(B, T, Hkv, dh)
    v = v.reshape(B, T, Hkv, dh)
    if cfg.qk_norm:
        q = C.rms_norm(q, lp["q_norm"])
        k = C.rms_norm(k, lp["k_norm"])
    q = C.rope(q, positions, cfg.rope_theta)
    k = C.rope(k, positions, cfg.rope_theta)
    window = _layer_window(cfg, layer_idx)

    if kv_cache is None:
        raise NotImplementedError(
            "the cache-free forward (flash attention) " + _TRAINING_SLICE)
    kc, vc = kv_cache
    # lax.dynamic_update_slice clamps its start so the update fits
    pos0 = min(max(cache_len, 0), kc.shape[1] - T)
    kc[:, pos0:pos0 + T] = k
    vc[:, pos0:pos0 + T] = v
    o = C.decode_attention(q, kc, vc, cache_len + T, window=window)
    o = o.reshape(B, T, H * dh)
    out = torch.einsum("bth,hd->btd", o, lp["wo"].to(o.dtype))
    return x + out, (kc, vc)


def _dense_ffn(x, lp):
    h = C.rms_norm(x, lp["norm"])
    return x + C.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _moe_ffn(x, lp, cfg: TransformerConfig):
    raise NotImplementedError("the MoE FFN " + _TRAINING_SLICE)


def forward(
    params: Transformer,
    tokens: torch.Tensor,         # [B, T] int32
    cfg: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [L, B, S, Hkv, dh] x2
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor,
           Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (hidden [B,T,D], aux_loss, kv_caches written in place)."""
    if kv_caches is None:
        raise NotImplementedError(
            "the cache-free forward (flash attention) " + _TRAINING_SLICE)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = params.embed[tokens.long()].to(cfg.dtype)
    kcs, vcs = kv_caches
    cache_len = int(cache_len)
    for i in range(cfg.n_layers):
        x, _ = _attention(x, _layer(params.attn, i), cfg, i, positions,
                          kv_cache=(kcs[i], vcs[i]), cache_len=cache_len)
        lp = _layer(params.ffn, i)
        x = _moe_ffn(x, lp, cfg)[0] if cfg.is_moe else _dense_ffn(x, lp)
    x = C.rms_norm(x, params.final_norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, (kcs, vcs)


# --------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------- #
def loss_fn(params, batch, cfg: TransformerConfig):
    raise NotImplementedError("loss_fn " + _TRAINING_SLICE)


def make_kv_cache_specs(cfg: TransformerConfig, batch: int, max_seq: int
                        ) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]:
    """(shape, dtype) of the decode KV cache's keys and of its values."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return (shape, cfg.dtype), (shape, cfg.dtype)


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
    logits = torch.einsum("btd,vd->btv", h.float(), params.embed.float())
    return logits[:, -1], new_caches


def prefill_step(params, tokens, cfg: TransformerConfig):
    raise NotImplementedError("prefill_step " + _TRAINING_SLICE)
