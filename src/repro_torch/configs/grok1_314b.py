"""grok-1-314b — 64L d_model=6144 48H (GQA kv=8, d_head=128) d_ff=32768,
MoE 8 experts top-2, vocab 131072.  [hf:xai-org/grok-1; unverified]

The port's copy of ``repro/configs/grok1_314b.py``'s ``CONFIG`` and
``SMOKE`` (its dry-run ``ARCH`` and ``smoke`` are objects of the
reference's ``configs/base.py`` and are not carried).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab=131072, moe_experts=8, moe_top_k=2,
    attn_chunk=512,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=128, moe_experts=4, moe_top_k=2, attn_chunk=32,
    loss_chunks=2,
)
