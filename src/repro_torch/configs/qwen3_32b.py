"""qwen3-32b — 64L d_model=5120 64H (GQA kv=8, d_head=128) d_ff=25600,
vocab=151936, dense, qk_norm.  [hf:Qwen/Qwen3-32B; hf]

The port's copy of ``repro/configs/qwen3_32b.py``'s ``CONFIG``,
``SMOKE`` and ``smoke`` (its dry-run ``ARCH`` waits with
``configs/base.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-32b",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
    attn_chunk=512,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=128, attn_chunk=32, loss_chunks=2,
)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import lm_smoke

    lm_smoke(SMOKE, device=device)
