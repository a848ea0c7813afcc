"""equiformer-v2 — 12L d_hidden=128 l_max=6 m_max=2 8 heads, SO(2)-eSCN
equivariant graph attention.  [arXiv:2306.12059; unverified]

The port's copy of ``repro/configs/equiformer_v2_cfg.py``'s ``CONFIG``,
``SMOKE``, ``smoke``, ``_flops`` (the reference's model FLOPs) and
dry-run ``ARCH``.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs import base
from repro_torch.models.gnn import equiformer_v2 as module
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config

CONFIG = EquiformerV2Config(
    n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8,
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, l_max=2,
                            m_max=1, n_heads=2, n_radial=4)


def _flops(cfg, n, e2):
    n_lm = cfg.lm_count
    per_edge = 2 * n_lm * cfg.d_hidden**2 + 3 * n_lm * cfg.d_hidden
    per_node = 2 * n_lm * cfg.d_hidden**2 + 2 * cfg.d_hidden**2
    return 3.0 * cfg.n_layers * (e2 * per_edge + n * per_node)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import gnn_smoke

    gnn_smoke(module, SMOKE, molecular=True, device=device)


ARCH = base.ArchDef(
    arch_id="equiformer-v2",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    build=functools.partial(
        base.gnn_build, module, CONFIG, molecular=True, flops_fn=_flops
    ),
    smoke=smoke,
)
