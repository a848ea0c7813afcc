"""graphsage-reddit — 2L d_hidden=128 mean aggregator, fanout 25-10.
[arXiv:1706.02216; paper]

The port's copy of ``repro/configs/graphsage_reddit.py``'s ``CONFIG``,
``SMOKE`` and ``smoke`` (its dry-run ``ARCH`` and ``_flops`` wait with
``configs/base.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.gnn import graphsage as module
from repro_torch.models.gnn.graphsage import GraphSAGEConfig

CONFIG = GraphSAGEConfig(n_layers=2, d_hidden=128, sample_sizes=(25, 10))

SMOKE = dataclasses.replace(CONFIG, d_hidden=16, n_classes=4,
                            sample_sizes=(4, 3))


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import gnn_smoke

    gnn_smoke(module, SMOKE, molecular=False, sampled=True, device=device)
