"""dimenet — 6 blocks d_hidden=128 n_bilinear=8 spherical=7 radial=6.
[arXiv:2003.03123; unverified]

The port's copy of ``repro/configs/dimenet_cfg.py``'s ``CONFIG``,
``SMOKE``, ``smoke``, ``_flops`` (the reference's model FLOPs) and
dry-run ``ARCH``.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs import base
from repro_torch.models.gnn import dimenet as module
from repro_torch.models.gnn.dimenet import DimeNetConfig

CONFIG = DimeNetConfig(
    n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6,
)

SMOKE = dataclasses.replace(CONFIG, n_blocks=2, d_hidden=16, n_bilinear=4,
                            n_spherical=3, n_radial=3)


def _flops(cfg, n, e2):
    t = 8 * e2  # capped triplet budget
    per_edge = 2 * cfg.d_hidden**2 + 2 * cfg.d_hidden * cfg.n_radial
    per_tri = 2 * cfg.d_hidden * cfg.n_bilinear
    per_node = 4 * cfg.d_hidden**2
    return 3.0 * cfg.n_blocks * (e2 * per_edge + t * per_tri + n * per_node)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import gnn_smoke

    gnn_smoke(module, SMOKE, molecular=True, device=device)


ARCH = base.ArchDef(
    arch_id="dimenet",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    build=functools.partial(
        base.gnn_build, module, CONFIG, molecular=True, flops_fn=_flops
    ),
    smoke=smoke,
)
