"""Vertex-weighted undirected graph container (host side, numpy CSR).

The paper (§3) represents the input as a vertex-weighted directed graph in
adjacency-array format: every undirected edge {u, v} is stored as the two
directed edges (u, v) and (v, u).  This module is the host-side source of
truth from which local (per-PE) subgraphs with ghost halos are carved
(see :mod:`repro_torch.core.partition`).

Weights are non-negative int32 (the paper draws uniform integers from
[1, 200]).  Keeping integer weights makes every rule test exact — no
float-tolerance case analysis in the reduction proofs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected vertex-weighted graph as symmetric CSR.

    Attributes:
      indptr:  [n+1] int64 — CSR row pointer.
      indices: [2m] int32 — CSR column indices (both edge directions present,
               rows sorted ascending).
      weights: [n] int32 — non-negative vertex weights.
    """

    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray

    # ------------------------------------------------------------------ #
    # Basic accessors
    # ------------------------------------------------------------------ #
    @property
    def n(self) -> int:
        return int(self.weights.shape[0])

    @property
    def num_directed_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def m(self) -> int:
        """Number of undirected edges."""
        return self.num_directed_edges // 2

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def edge_sources(self) -> np.ndarray:
        """Expanded CSR row index per directed edge ([2m] int32)."""
        return np.repeat(
            np.arange(self.n, dtype=np.int32), np.diff(self.indptr)
        )

    # ------------------------------------------------------------------ #
    # Validation
    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        n = self.n
        assert self.indptr.shape == (n + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.indices.shape[0]
        assert np.all(np.diff(self.indptr) >= 0), "indptr must be monotone"
        if self.indices.size:
            assert self.indices.min() >= 0 and self.indices.max() < n
        assert np.all(self.weights >= 0), "weights must be non-negative"
        src = self.edge_sources()
        assert not np.any(src == self.indices), "self loops are not allowed"
        # Symmetry: the multiset of (u, v) equals the multiset of (v, u).
        fwd = np.stack([src, self.indices], axis=1)
        rev = np.stack([self.indices, src], axis=1)
        fwd_sorted = fwd[np.lexsort((fwd[:, 1], fwd[:, 0]))]
        rev_sorted = rev[np.lexsort((rev[:, 1], rev[:, 0]))]
        assert np.array_equal(fwd_sorted, rev_sorted), "graph must be symmetric"
        # Rows sorted, no parallel edges.
        for v in range(min(n, 0)):  # pragma: no cover - spot check disabled
            nb = self.neighbors(v)
            assert np.all(np.diff(nb) > 0)

    # ------------------------------------------------------------------ #
    # Queries used by solvers / tests
    # ------------------------------------------------------------------ #
    def has_edge(self, u: int, v: int) -> bool:
        nb = self.neighbors(u)
        i = np.searchsorted(nb, v)
        return bool(i < nb.shape[0] and nb[i] == v)

    def is_independent_set(self, members: np.ndarray) -> bool:
        """members: [n] bool mask."""
        src = self.edge_sources()
        both = members[src] & members[self.indices]
        return not bool(np.any(both))

    def set_weight(self, members: np.ndarray) -> int:
        return int(self.weights[members].sum(dtype=np.int64))

    def induced_subgraph(self, keep: np.ndarray) -> Tuple["Graph", np.ndarray]:
        """Induced subgraph on `keep` (bool mask). Returns (graph, old_ids)."""
        old_ids = np.flatnonzero(keep)
        remap = -np.ones(self.n, dtype=np.int64)
        remap[old_ids] = np.arange(old_ids.shape[0])
        src = self.edge_sources()
        emask = keep[src] & keep[self.indices]
        new_src = remap[src[emask]]
        new_dst = remap[self.indices[emask]]
        return (
            from_directed_pairs(
                old_ids.shape[0],
                new_src.astype(np.int64),
                new_dst.astype(np.int64),
                self.weights[old_ids],
            ),
            old_ids,
        )


# ---------------------------------------------------------------------- #
# Constructors
# ---------------------------------------------------------------------- #
def from_edge_list(
    n: int,
    edges: Iterable[Tuple[int, int]],
    weights: np.ndarray,
) -> Graph:
    """Build from undirected edge list; dedups, drops self loops, symmetrizes."""
    e = np.asarray(list(edges), dtype=np.int64).reshape(-1, 2)
    if e.size:
        e = e[e[:, 0] != e[:, 1]]
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        und = np.unique(np.stack([lo, hi], axis=1), axis=0)
        src = np.concatenate([und[:, 0], und[:, 1]])
        dst = np.concatenate([und[:, 1], und[:, 0]])
    else:
        src = np.zeros((0,), dtype=np.int64)
        dst = np.zeros((0,), dtype=np.int64)
    return from_directed_pairs(n, src, dst, weights)


def from_directed_pairs(
    n: int, src: np.ndarray, dst: np.ndarray, weights: np.ndarray
) -> Graph:
    """Build CSR from directed pairs (assumed already symmetric & loop-free)."""
    order = np.lexsort((dst, src))
    src = src[order]
    dst = dst[order]
    counts = np.bincount(src, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    g = Graph(
        indptr=indptr,
        indices=dst.astype(np.int32),
        weights=np.asarray(weights, dtype=np.int32),
    )
    return g


def relabel(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel vertices: new id of old vertex v is perm[v]."""
    src = perm[g.edge_sources()]
    dst = perm[g.indices]
    w = np.empty_like(g.weights)
    w[perm] = g.weights
    return from_directed_pairs(g.n, src.astype(np.int64), dst.astype(np.int64), w)
