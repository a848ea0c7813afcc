"""dimenet — 6 blocks d_hidden=128 n_bilinear=8 spherical=7 radial=6.
[arXiv:2003.03123; unverified]

The port's copy of ``repro/configs/dimenet_cfg.py``'s ``CONFIG``,
``SMOKE`` and ``smoke`` (its dry-run ``ARCH`` and ``_flops`` wait with
``configs/base.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.gnn import dimenet as module
from repro_torch.models.gnn.dimenet import DimeNetConfig

CONFIG = DimeNetConfig(
    n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6,
)

SMOKE = dataclasses.replace(CONFIG, n_blocks=2, d_hidden=16, n_bilinear=4,
                            n_spherical=3, n_radial=3)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import gnn_smoke

    gnn_smoke(module, SMOKE, molecular=True, device=device)
