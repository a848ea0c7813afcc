"""mistral-nemo-12b — 40L d_model=5120 32H (GQA kv=8, d_head=128)
d_ff=14336, vocab=131072, dense, 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]

The port's copy of ``repro/configs/mistral_nemo_12b.py``'s ``CONFIG``,
``SMOKE`` and ``smoke`` (its dry-run ``ARCH`` waits with
``configs/base.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="mistral-nemo-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072, rope_theta=1_000_000.0, attn_chunk=512,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=128, attn_chunk=32, loss_chunks=2,
)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import lm_smoke

    lm_smoke(SMOKE, device=device)
