"""graphsage-reddit — 2L d_hidden=128 mean aggregator, fanout 25-10.
[arXiv:1706.02216; paper]

The port's copy of ``repro/configs/graphsage_reddit.py``'s ``CONFIG``,
``SMOKE``, ``smoke``, ``_flops`` (the reference's model FLOPs) and
dry-run ``ARCH``.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs import base
from repro_torch.models.gnn import graphsage as module
from repro_torch.models.gnn.graphsage import GraphSAGEConfig

CONFIG = GraphSAGEConfig(n_layers=2, d_hidden=128, sample_sizes=(25, 10))

SMOKE = dataclasses.replace(CONFIG, d_hidden=16, n_classes=4,
                            sample_sizes=(4, 3))


def _flops(cfg, n, e2):
    per_node = 2 * 2 * cfg.d_feat * cfg.d_hidden
    per_edge = 2 * cfg.d_hidden
    return 3.0 * cfg.n_layers * (n * per_node + e2 * per_edge)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import gnn_smoke

    gnn_smoke(module, SMOKE, molecular=False, sampled=True, device=device)


ARCH = base.ArchDef(
    arch_id="graphsage-reddit",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    build=functools.partial(
        base.gnn_build, module, CONFIG, molecular=False, flops_fn=_flops
    ),
    smoke=smoke,
)
