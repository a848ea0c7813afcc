"""Locality-improving vertex orders — the paper's partitioning enhancement.

The paper (§7.1, Table C.3) shows that partitioning the input with
dKaMinPar before reducing improves reduction impact (|V'|/|V| 0.38 → 0.25
median) at ~10× running-time cost.  Contiguous 1D blocks over a
locality-aware vertex ORDER approximate that effect at near-zero cost: a
BFS order places neighbors in the same block far more often than the
natural order of, e.g., KaGen-style generators.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.graph import Graph, relabel


def bfs_order(g: Graph, start: int = 0) -> np.ndarray:
    """perm[v] = new id of old vertex v, by BFS layers (components chained)."""
    n = g.n
    perm = -np.ones(n, dtype=np.int64)
    nxt = 0
    seen = np.zeros(n, dtype=bool)
    for root in range(n):
        if seen[root]:
            continue
        q = deque([root])
        seen[root] = True
        while q:
            v = q.popleft()
            perm[v] = nxt
            nxt += 1
            for u in g.neighbors(v).tolist():
                if not seen[u]:
                    seen[u] = True
                    q.append(u)
    return perm


def relabel_bfs(g: Graph) -> Graph:
    return relabel(g, bfs_order(g))


def cut_edges_fraction(g: Graph, p: int) -> float:
    """Fraction of edges crossing contiguous p-block boundaries."""
    starts = np.linspace(0, g.n, p + 1).astype(np.int64)
    block = np.searchsorted(starts, np.arange(g.n), side="right") - 1
    src = g.edge_sources()
    return float((block[src] != block[g.indices]).mean())
