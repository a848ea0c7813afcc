"""Three-term roofline of a dry-run cell on the NVIDIA H100 SXM5.

The port of ``repro/analysis/roofline.py`` (whose constants are TPU
v5e's):

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

The terms are one device's (``launch/dryrun.py``): rank 0's count of a
sharded program (LM, DLRM) or :mod:`repro_torch.analysis.count`'s totals
of a run divided over the mesh's chips (GNN).  Plus MODEL_FLOPS / FLOPs —
the useful-compute fraction that catches recompute waste.  The collective
term takes the NVLink rate inside one 8-card node (``LINK_BW``) whatever
the mesh: a 256- or 512-card mesh spans nodes, whose links are slower.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM5 per-card constants (NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 column, at the full 700 W power limit): dense bf16 tensor-core
# FLOP/s (the reference too scores against one bf16 peak), HBM3 bytes/s,
# NVLink bytes/s in one direction (900 GB/s bidirectional).
PEAK_FLOPS = 989.4e12    # bf16 FLOP/s
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 4.5e11         # bytes/s per direction


@dataclasses.dataclass
class Roofline:
    flops: float
    mem_bytes: float
    coll_bytes: float
    model_flops: float

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.mem_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-model step time (max of the three overlapping terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / FLOPs (recompute/redundancy waste detector)."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the modelled step
        time: (MODEL_FLOPS/chips)/peak ÷ t_bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.t_bound

    def report(self) -> Dict[str, float]:
        return dict(
            flops_per_device=self.flops,
            hbm_bytes_per_device=self.mem_bytes,
            collective_bytes_per_device=self.coll_bytes,
            t_compute_s=self.t_compute,
            t_memory_s=self.t_memory,
            t_collective_s=self.t_collective,
            bottleneck=self.bottleneck,
            model_flops_per_device=self.model_flops,
            useful_fraction=self.useful_fraction,
            roofline_fraction=self.roofline_fraction,
        )


def from_cell(cost: Dict, coll: Dict[str, int], model_flops_total: float,
              n_chips: int) -> Roofline:
    """``cost`` and ``coll`` per device (``flops``, ``bytes accessed``;
    bytes by collective kind), ``model_flops_total`` over the mesh."""
    flops = float(cost.get("flops", 0.0))
    mem = float(cost.get("bytes accessed", 0.0))
    cb = float(sum(coll.values()))
    return Roofline(
        flops=flops, mem_bytes=mem, coll_bytes=cb,
        model_flops=model_flops_total / max(n_chips, 1),
    )
