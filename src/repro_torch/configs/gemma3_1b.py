"""gemma3-1b — 26L d_model=1152 4H (GQA kv=1, d_head=256) d_ff=6912,
vocab=262144, 5:1 local:global interleave (sliding window 512), 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]

The port's copy of ``repro/configs/gemma3_1b.py``'s ``CONFIG``,
``SMOKE`` and ``smoke`` (its dry-run ``ARCH`` waits with
``configs/base.py``).  Like the reference's ``TransformerConfig``, it
models neither gemma3's embedding scale nor its post-norms.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_head=256,
    d_ff=6912, vocab=262144, local_window=512, global_every=6,
    rope_theta=1_000_000.0, attn_chunk=512,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab=128, local_window=8, global_every=3, attn_chunk=16,
    loss_chunks=2,
)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import lm_smoke

    lm_smoke(SMOKE, device=device)
