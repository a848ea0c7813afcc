"""dlrm-mlperf — MLPerf DLRM (Criteo 1TB): 13 dense + 26 sparse features,
embed_dim 128, bot 13-512-256-128, top 1024-1024-512-256-1, dot interaction.
[arXiv:1906.00091; paper]

The port's copy of ``repro/configs/dlrm_mlperf.py``'s ``CONFIG``,
``SMOKE`` and ``smoke`` (its dry-run ``ARCH`` waits with
``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig()

SMOKE = dataclasses.replace(
    CONFIG,
    vocabs=(64, 32, 16, 8, 100, 3, 50, 20, 63, 128, 256, 40, 10, 22, 11,
            15, 4, 9, 14, 200, 250, 300, 58, 12, 10, 36),
    embed_dim=16,
    bot_mlp=(13, 32, 16),
    top_mlp=(64, 32, 1),
)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import dlrm_smoke

    dlrm_smoke(SMOKE, device=device)
