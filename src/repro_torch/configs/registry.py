"""Arch registry: ``--arch <id>`` resolution for the dry-run.

The port of ``repro/configs/registry.py``: the same eleven architectures,
in the same order, each an :class:`~repro_torch.configs.base.ArchDef`."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchDef


def _load() -> Dict[str, ArchDef]:
    from repro_torch.configs import (
        dimenet_cfg, dlrm_mlperf, equiformer_v2_cfg, gatedgcn_cfg,
        gemma3_1b, graphsage_reddit, grok1_314b, mistral_nemo_12b, mwis,
        qwen3_32b, qwen3_moe_235b,
    )

    archs = [
        qwen3_moe_235b.ARCH, grok1_314b.ARCH, mistral_nemo_12b.ARCH,
        qwen3_32b.ARCH, gemma3_1b.ARCH,
        equiformer_v2_cfg.ARCH, dimenet_cfg.ARCH, gatedgcn_cfg.ARCH,
        graphsage_reddit.ARCH,
        dlrm_mlperf.ARCH,
        mwis.ARCH,
    ]
    return {a.arch_id: a for a in archs}


ARCHS = _load()


def get(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}"
        )
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) dry-run cell; skipped cells annotated."""
    out = []
    for a in ARCHS.values():
        for s in a.shapes:
            out.append((a.arch_id, s, None))
        if include_skipped:
            for s, why in a.skips.items():
                out.append((a.arch_id, s, why))
    return out
