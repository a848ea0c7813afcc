"""Fanout neighbor sampler (GraphSAGE-style) — the real sampler required by
the ``minibatch_lg`` shape.

Given a CSR graph, seed nodes and fanouts (f_1, ..., f_k), builds a padded
sampled subgraph with static shapes:

  * nodes: seeds first, then layer-by-layer sampled frontiers (deduped),
  * edges: (src_local → dst_local) for every sampled (neighbor → target),
  * padding uses the sentinel index n_sub so model code can mask uniformly.

The sampler runs host-side (numpy RNG) — it is the data-pipeline stage of
the framework; its output feeds the train step.  A copy of
``repro/graphs/sampler.py`` over the port's own ``core/graph.py``: for the
same ``rng`` it returns the reference's arrays bit for bit.  On the *reduced*
graph (after `core.distributed` kernelization) the same sampler applies —
that is the paper-technique × GNN-substrate integration point.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    node_ids: np.ndarray   # [n_sub] global ids (pad = -1)
    row: np.ndarray        # [e_sub] local src (pad = n_sub)
    col: np.ndarray        # [e_sub] local dst (pad = n_sub)
    n_valid: int
    n_seeds: int

    @property
    def n_sub(self) -> int:
        return int(self.node_ids.shape[0])


def sample_fanout(
    g: Graph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    *,
    rng: np.random.Generator,
    pad_nodes: int | None = None,
    pad_edges: int | None = None,
) -> SampledSubgraph:
    """k-hop fanout sampling with dedup; returns a padded subgraph."""
    seeds = np.asarray(seeds, dtype=np.int64)
    order: Dict[int, int] = {int(s): i for i, s in enumerate(seeds)}
    nodes = list(seeds)
    edges_src: list = []
    edges_dst: list = []
    frontier = seeds
    for f in fanouts:
        nxt = []
        for v in frontier:
            nbrs = g.neighbors(int(v))
            if nbrs.shape[0] == 0:
                continue
            take = nbrs if nbrs.shape[0] <= f else rng.choice(
                nbrs, size=f, replace=False
            )
            for u in take.tolist():
                if u not in order:
                    order[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                edges_src.append(order[u])
                edges_dst.append(order[int(v)])
        frontier = np.asarray(nxt, dtype=np.int64)
    n_valid = len(nodes)
    n_e = len(edges_src)
    n_sub = pad_nodes or n_valid
    e_sub = pad_edges or n_e
    assert n_valid <= n_sub and n_e <= e_sub, "pad sizes too small"
    node_ids = np.full(n_sub, -1, dtype=np.int64)
    node_ids[:n_valid] = nodes
    row = np.full(e_sub, n_sub, dtype=np.int32)
    col = np.full(e_sub, n_sub, dtype=np.int32)
    row[:n_e] = edges_src
    col[:n_e] = edges_dst
    return SampledSubgraph(
        node_ids=node_ids, row=row, col=col,
        n_valid=n_valid, n_seeds=int(seeds.shape[0]),
    )


def build_triplets(
    row: np.ndarray, col: np.ndarray, n: int, *,
    budget: int, cap_per_edge: int = 8,
) -> np.ndarray:
    """Capped triplet list (in-edge k→j, out-edge j→i) for angular GNNs.

    For each out-edge (j→i), pair with up to `cap_per_edge` in-edges (k→j),
    k ≠ i; truncated to `budget` rows, padded with e_sub sentinels.
    """
    e_sub = row.shape[0]
    by_dst: Dict[int, list] = {}
    for e in range(e_sub):
        if row[e] < n:
            by_dst.setdefault(int(col[e]), []).append(e)
    out = []
    for e_out in range(e_sub):
        j = int(row[e_out])
        if j >= n:
            continue
        i = int(col[e_out])
        cnt = 0
        for e_in in by_dst.get(j, []):
            if int(row[e_in]) == i:
                continue
            out.append((e_in, e_out))
            cnt += 1
            if cnt >= cap_per_edge:
                break
        if len(out) >= budget:
            break
    tri = np.full((budget, 2), e_sub, dtype=np.int32)
    k = min(len(out), budget)
    if k:
        tri[:k] = np.asarray(out[:k], dtype=np.int32)
    return tri
