"""qwen3-moe-235b-a22b — 94L d_model=4096 64H (GQA kv=4, d_head=128)
MoE 128 experts top-8 (expert d_ff=1536), vocab 151936, qk_norm.
[hf:Qwen/Qwen3-235B-A22B family; verified tier: hf]

The port's copy of ``repro/configs/qwen3_moe_235b.py``'s ``CONFIG`` and
``SMOKE``, and its ``smoke`` (its dry-run ``ARCH`` is an object of the
reference's ``configs/base.py`` and waits with it).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936, moe_experts=128, moe_top_k=8, qk_norm=True,
    rope_theta=1_000_000.0, attn_chunk=512,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=128, moe_experts=8, moe_top_k=2, attn_chunk=32,
    loss_chunks=2,
)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import lm_smoke

    lm_smoke(SMOKE, device=device)
