"""gatedgcn — 16L d_hidden=70 gated aggregator. [arXiv:2003.00982; paper]

The port's copy of ``repro/configs/gatedgcn_cfg.py``'s ``CONFIG``,
``SMOKE``, ``smoke``, ``_flops`` (the reference's model FLOPs) and
dry-run ``ARCH``.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs import base
from repro_torch.models.gnn import gatedgcn as module
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig

CONFIG = GatedGCNConfig(n_layers=16, d_hidden=70)

SMOKE = dataclasses.replace(CONFIG, n_layers=3, d_hidden=16, n_classes=4)


def _flops(cfg, n, e2):
    per_node = 5 * 2 * cfg.d_hidden**2   # U,V,E1,E2,E3 matmuls
    per_edge = 6 * cfg.d_hidden
    return 3.0 * cfg.n_layers * (n * per_node + e2 * per_edge)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import gnn_smoke

    gnn_smoke(module, SMOKE, molecular=False, device=device)


ARCH = base.ArchDef(
    arch_id="gatedgcn",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    build=functools.partial(
        base.gnn_build, module, CONFIG, molecular=False, flops_fn=_flops
    ),
    smoke=smoke,
)
