"""Exact MWIS on small (sub)graphs via adjacency bitmasks.

Two roles:

1. Host-side oracle (`mwis_exact`) for property tests and for the
   sequential baseline's sub-solver — the stand-in for the paper's use of
   KaMIS wB&R [32] on bounded subproblems (§5.1 caps them at 10 vertices).

2. A fully-vectorised in-JIT variant (`alpha_neighborhood_jnp`, see
   :mod:`repro_torch.core.rules`) used by Distributed Heavy Vertex: exhaustive
   enumeration of the 2^K subsets of a K-capped neighborhood with
   independence checked against a K×K adjacency bitmask.  On TPU this is a
   dense integer workload — ideal for the VPU — instead of the pointer-chasing
   branch-and-reduce a CPU would run.
"""

from __future__ import annotations

import sys
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from repro_torch.core.graph import Graph

sys.setrecursionlimit(100000)


def adjacency_masks(g: Graph) -> List[int]:
    masks = [0] * g.n
    src = g.edge_sources()
    for u, v in zip(src.tolist(), g.indices.tolist()):
        masks[u] |= 1 << v
    return masks


def mwis_exact(g: Graph) -> Tuple[int, np.ndarray]:
    """Exact MWIS weight + one optimal member mask. Exponential; n ≤ ~40."""
    n = g.n
    masks = adjacency_masks(g)
    w = g.weights.astype(np.int64).tolist()

    @lru_cache(maxsize=None)
    def solve(allowed: int) -> int:
        if allowed == 0:
            return 0
        # Pick the lowest-indexed allowed vertex; branch on it.
        v = (allowed & -allowed).bit_length() - 1
        without = solve(allowed & ~(1 << v))
        with_v = w[v] + solve(allowed & ~masks[v] & ~(1 << v))
        return max(without, with_v)

    full = (1 << n) - 1
    best = solve(full)

    # Reconstruct one optimum by re-tracing the DP.
    members = np.zeros(n, dtype=bool)
    allowed = full
    remaining = best
    while allowed:
        v = (allowed & -allowed).bit_length() - 1
        with_v = w[v] + solve(allowed & ~masks[v] & ~(1 << v))
        if with_v == remaining:
            members[v] = True
            remaining -= w[v]
            allowed &= ~masks[v] & ~(1 << v)
        else:
            allowed &= ~(1 << v)
    return int(best), members


def alpha_subset(weights: np.ndarray, adj_bits: np.ndarray) -> int:
    """α of a ≤K-vertex graph given per-vertex adjacency bitmasks (numpy).

    Mirrors the vectorised in-JIT form: enumerate all 2^K subsets, keep
    independent ones, maximise weight.  `adj_bits[i]` has bit j set iff
    vertices i and j are adjacent.
    """
    k = int(weights.shape[0])
    if k == 0:
        return 0
    subsets = np.arange(1 << k, dtype=np.int64)
    sel = ((subsets[:, None] >> np.arange(k)[None, :]) & 1).astype(bool)
    conflict = np.zeros(subsets.shape[0], dtype=bool)
    for i in range(k):
        conflict |= sel[:, i] & ((subsets & int(adj_bits[i])) != 0)
    totals = sel @ weights.astype(np.int64)
    totals[conflict] = -1
    return int(totals.max(initial=0))
