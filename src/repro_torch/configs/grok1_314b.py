"""grok-1-314b — 64L d_model=6144 48H (GQA kv=8, d_head=128) d_ff=32768,
MoE 8 experts top-2, vocab 131072.  [hf:xai-org/grok-1; unverified]

The port's copy of ``repro/configs/grok1_314b.py``'s ``CONFIG`` and
``SMOKE``, its ``smoke`` and its dry-run ``ARCH``.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs import base
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


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import lm_smoke

    lm_smoke(SMOKE, device=device)


ARCH = base.ArchDef(
    arch_id="grok-1-314b",
    family="lm",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    build=functools.partial(base.lm_build, CONFIG),
    smoke=smoke,
    skips={"long_500k": "pure full-attention arch (assignment rule)"},
)
