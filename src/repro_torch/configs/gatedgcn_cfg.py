"""gatedgcn — 16L d_hidden=70 gated aggregator. [arXiv:2003.00982; paper]

The port's copy of ``repro/configs/gatedgcn_cfg.py``'s ``CONFIG``,
``SMOKE`` and ``smoke`` (its dry-run ``ARCH`` and ``_flops`` wait with
``configs/base.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.gnn import gatedgcn as module
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig

CONFIG = GatedGCNConfig(n_layers=16, d_hidden=70)

SMOKE = dataclasses.replace(CONFIG, n_layers=3, d_hidden=16, n_classes=4)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import gnn_smoke

    gnn_smoke(module, SMOKE, molecular=False, device=device)
