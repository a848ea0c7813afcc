"""Sequential reduce / reduce-and-peel baseline (HtWIS-style, numpy/python).

This is the repo's stand-in for the paper's sequential baseline HtWIS
(Gu et al. [25]) and simultaneously the *reference semantics* for every
reduction rule the distributed path implements.  It runs the full rule
set of §5.1 — including the folding rules (V-Shape merge, Neighborhood
Folding) that the distributed reduction model cannot express (no new cut
edges / static shapes) — so comparing kernels quantifies exactly what the
border restrictions cost, mirroring the paper's own sequential-vs-p
comparison (Fig. 7.1).

Rule order follows §5.1:
  degree-zero/one → neighborhood removal → simplicial weight transfer →
  simplicial vertex → V-shape (deg-2 cases of neighborhood folding) →
  basic single-edge → extended single-edge → neighborhood folding →
  heavy vertex (exact sub-MWIS, subproblem capped at `heavy_cap` = 10,
  the paper's cap).

Everything is exact integer arithmetic.  Reconstruction replays the fold
log in reverse; `solve()` returns a verified independent set.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.bitset_mwis import alpha_subset
from repro_torch.core.graph import Graph

UNDECIDED, INCLUDED, EXCLUDED, FOLDED = 0, 1, 2, 3


@dataclasses.dataclass
class SeqConfig:
    heavy_cap: int = 10        # max |N(v)| for the exact sub-MWIS (paper: 10)
    simplicial_cap: int = 32   # max degree for clique tests
    fold_cap: int = 8          # max |N(v)| for neighborhood folding
    use_folding: bool = True   # V-shape merge + neighborhood folding
    use_single_edge: bool = True
    use_heavy: bool = True
    max_rounds: int = 10_000_000


class SequentialReducer:
    """Mutable reduction engine over adjacency sets."""

    def __init__(self, g: Graph, cfg: Optional[SeqConfig] = None):
        self.cfg = cfg or SeqConfig()
        self.g = g
        n = g.n
        self.adj: List[Set[int]] = [set(g.neighbors(v).tolist()) for v in range(n)]
        self.w: List[int] = g.weights.astype(np.int64).tolist()
        self.status: List[int] = [UNDECIDED] * n
        self.offset = 0
        # log entries: ("fold1", v, u) | ("wt", v, nbrs) | ("nf", v, nbrs, vp)
        self.log: List[tuple] = []
        self.n_orig = n

    # ----------------------------------------------------------------- #
    # primitive mutations
    # ----------------------------------------------------------------- #
    def _detach(self, v: int) -> None:
        for u in self.adj[v]:
            self.adj[u].discard(v)
        self.adj[v] = set()

    def include(self, v: int) -> None:
        assert self.status[v] == UNDECIDED
        self.status[v] = INCLUDED
        for u in list(self.adj[v]):
            if self.status[u] == UNDECIDED:
                self.exclude(u)
        self._detach(v)

    def exclude(self, v: int) -> None:
        assert self.status[v] == UNDECIDED
        self.status[v] = EXCLUDED
        self._detach(v)

    def alive(self, v: int) -> bool:
        return self.status[v] == UNDECIDED

    def alive_vertices(self) -> List[int]:
        return [v for v in range(len(self.w)) if self.status[v] == UNDECIDED]

    def nbr_weight(self, v: int) -> int:
        return sum(self.w[u] for u in self.adj[v])

    # ----------------------------------------------------------------- #
    # rules — each returns True if it changed the graph at v
    # ----------------------------------------------------------------- #
    def _rule_low_degree(self, v: int) -> bool:
        deg = len(self.adj[v])
        if deg == 0:
            self.include(v)
            return True
        if deg == 1:
            (u,) = self.adj[v]
            if self.w[v] >= self.w[u]:
                self.include(v)
            else:
                # degree-one fold (Chang/Gu): w(u) -= w(v); v in I iff u not.
                self.w[u] -= self.w[v]
                self.offset += self.w[v]
                self.status[v] = FOLDED
                self._detach(v)
                self.log.append(("fold1", v, u))
            return True
        return False

    def _rule_neighborhood_removal(self, v: int) -> bool:
        if self.w[v] >= self.nbr_weight(v):
            self.include(v)
            return True
        return False

    def _is_simplicial(self, v: int) -> bool:
        nbrs = list(self.adj[v])
        if len(nbrs) > self.cfg.simplicial_cap:
            return False
        for i, a in enumerate(nbrs):
            for b in nbrs[i + 1:]:
                if b not in self.adj[a]:
                    return False
        return True

    def _rule_simplicial(self, v: int) -> bool:
        if not self._is_simplicial(v):
            return False
        nbrs = list(self.adj[v])
        mx = max((self.w[u] for u in nbrs), default=0)
        if self.w[v] >= mx:
            self.include(v)
            return True
        # Simplicial weight transfer (Reduction 4.5): v must be max-weight
        # among the simplicial vertices of its neighborhood (paper: S(v)).
        if any(
            self.w[u] > self.w[v] and self._is_simplicial(u) for u in nbrs
        ):
            return False
        wv = self.w[v]
        removed = [u for u in nbrs if self.w[u] <= wv]
        survivors = [u for u in nbrs if self.w[u] > wv]
        self.log.append(("wt", v, tuple(nbrs)))
        self.status[v] = FOLDED
        self._detach(v)
        for u in removed:
            if self.status[u] == UNDECIDED:
                self.exclude(u)
        for u in survivors:
            self.w[u] -= wv
        self.offset += wv
        return True

    def _rule_basic_single_edge(self, v: int) -> bool:
        # exclude v if some neighbor u has w(u) >= w(N(u) \ N(v)).
        for u in self.adj[v]:
            s = sum(self.w[x] for x in self.adj[u] if x not in self.adj[v])
            # v itself is in N(u) \ N(v)  (v not adjacent to itself).
            if s <= self.w[u]:
                self.exclude(v)
                return True
        return False

    def _rule_extended_single_edge(self, v: int) -> bool:
        sv = self.nbr_weight(v)
        changed = False
        for u in list(self.adj[v]):
            if sv - self.w[u] <= self.w[v]:
                common = self.adj[v] & self.adj[u]
                for x in list(common):
                    if self.status[x] == UNDECIDED:
                        self.exclude(x)
                        changed = True
                sv = self.nbr_weight(v)
        return changed

    def _rule_neighborhood_fold(self, v: int) -> bool:
        nbrs = list(self.adj[v])
        if not (2 <= len(nbrs) <= self.cfg.fold_cap):
            return False
        # N(v) must be independent.
        for i, a in enumerate(nbrs):
            for b in nbrs[i + 1:]:
                if b in self.adj[a]:
                    return False
        s = sum(self.w[u] for u in nbrs)
        mn = min(self.w[u] for u in nbrs)
        if not (self.w[v] < s and self.w[v] >= s - mn):
            return False
        # Fold N[v] into a fresh vertex v' with w(v') = w(N(v)) - w(v).
        vp = len(self.w)
        self.w.append(s - self.w[v])
        self.status.append(UNDECIDED)
        new_nbrs: Set[int] = set()
        for u in nbrs:
            new_nbrs |= self.adj[u]
        new_nbrs -= set(nbrs)
        new_nbrs.discard(v)
        self.adj.append(set(new_nbrs))
        for x in new_nbrs:
            self.adj[x].add(vp)
        self.log.append(("nf", v, tuple(nbrs), vp))
        self.status[v] = FOLDED
        self._detach(v)
        for u in nbrs:
            self.status[u] = FOLDED
            self._detach(u)
        self.offset += self.w[v]
        return True

    def _rule_heavy_vertex(self, v: int) -> bool:
        nbrs = list(self.adj[v])
        if len(nbrs) > self.cfg.heavy_cap:
            return False
        k = len(nbrs)
        pos = {u: i for i, u in enumerate(nbrs)}
        bits = np.zeros(k, dtype=np.int64)
        for i, a in enumerate(nbrs):
            for b in self.adj[a]:
                j = pos.get(b)
                if j is not None:
                    bits[i] |= 1 << j
        alpha = alpha_subset(
            np.array([self.w[u] for u in nbrs], dtype=np.int64), bits
        )
        if self.w[v] >= alpha:
            self.include(v)
            return True
        return False

    # ----------------------------------------------------------------- #
    # reduction loop
    # ----------------------------------------------------------------- #
    def reduce(self) -> None:
        """Exhaustively apply rules in the paper's §5.1 order (worklist)."""
        cfg = self.cfg
        pending = set(v for v in range(len(self.w)) if self.alive(v))
        rounds = 0
        while pending and rounds < cfg.max_rounds:
            rounds += 1
            v = pending.pop()
            if not self.alive(v):
                continue
            before_nbrs = set(self.adj[v])
            fired = (
                self._rule_low_degree(v)
                or self._rule_neighborhood_removal(v)
                or self._rule_simplicial(v)
                or (cfg.use_folding and self._rule_neighborhood_fold(v))
                or (cfg.use_single_edge and self._rule_basic_single_edge(v))
                or (cfg.use_single_edge and self._rule_extended_single_edge(v))
                or (cfg.use_heavy and self._rule_heavy_vertex(v))
            )
            if fired:
                # requeue the old neighborhood and its surroundings
                for u in before_nbrs:
                    if self.alive(u):
                        pending.add(u)
                        pending.update(
                            x for x in self.adj[u] if self.alive(x)
                        )
                if self.log and self.log[-1][0] == "nf":
                    vp = self.log[-1][3]
                    if self.alive(vp):
                        pending.add(vp)
                        pending.update(
                            x for x in self.adj[vp] if self.alive(x)
                        )

    # ----------------------------------------------------------------- #
    # peeling + reconstruction
    # ----------------------------------------------------------------- #
    def peel_one(self) -> Optional[int]:
        """Exclude argmax_v  w(N(v)) - w(v)  (HtWIS §6 peel criterion)."""
        best_v, best_score = None, None
        for v in range(len(self.w)):
            if self.alive(v):
                score = self.nbr_weight(v) - self.w[v]
                if best_score is None or score > best_score:
                    best_v, best_score = v, score
        if best_v is None:
            return None
        self.exclude(best_v)
        return best_v

    def reconstruct(self) -> np.ndarray:
        """Replay the fold log; returns bool member mask over ORIGINAL ids."""
        in_set = [s == INCLUDED for s in self.status]
        for rec in reversed(self.log):
            if rec[0] == "fold1":
                _, v, u = rec
                in_set[v] = not in_set[u]
            elif rec[0] == "wt":
                _, v, nbrs = rec
                in_set[v] = not any(in_set[u] for u in nbrs)
            elif rec[0] == "nf":
                _, v, nbrs, vp = rec
                if in_set[vp]:
                    for u in nbrs:
                        in_set[u] = True
                    in_set[v] = False
                    in_set[vp] = False
                else:
                    in_set[v] = True
        return np.array(in_set[: self.n_orig], dtype=bool)

    def kernel_stats(self) -> Tuple[int, int]:
        alive = self.alive_vertices()
        nv = len(alive)
        ne = sum(len(self.adj[v]) for v in alive) // 2
        return nv, ne


# --------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------- #
def reduce_graph(g: Graph, cfg: Optional[SeqConfig] = None) -> SequentialReducer:
    r = SequentialReducer(g, cfg)
    r.reduce()
    return r


def solve_reduce_and_peel(
    g: Graph, cfg: Optional[SeqConfig] = None
) -> Tuple[int, np.ndarray]:
    """HtWIS: reduce to fixpoint, peel one vertex, repeat; reconstruct."""
    r = SequentialReducer(g, cfg)
    r.reduce()
    while r.peel_one() is not None:
        r.reduce()
    members = r.reconstruct()
    assert g.is_independent_set(members), "reconstruction must be independent"
    return g.set_weight(members), members


def solve_greedy(g: Graph) -> Tuple[int, np.ndarray]:
    """Deterministic priority greedy == weighted Luby with (w, -id) priority.

    The distributed GS/GA solver must produce exactly this set (§6: a vertex
    is included iff it maximises weight among its neighbors, PE-rank/id
    tie-breaking) — used as its cross-check oracle.
    """
    order = sorted(range(g.n), key=lambda v: (-int(g.weights[v]), v))
    members = np.zeros(g.n, dtype=bool)
    blocked = np.zeros(g.n, dtype=bool)
    for v in order:
        if not blocked[v]:
            members[v] = True
            blocked[v] = True
            blocked[g.neighbors(v)] = True
    return g.set_weight(members), members


def solve_reduce_and_greedy(
    g: Graph, cfg: Optional[SeqConfig] = None
) -> Tuple[int, np.ndarray]:
    r = SequentialReducer(g, cfg)
    r.reduce()
    # Greedy on the residual kernel, then reconstruct folds.
    alive = r.alive_vertices()
    order = sorted(alive, key=lambda v: (-r.w[v], v))
    blocked = set()
    for v in order:
        if v not in blocked:
            r.status[v] = INCLUDED
            blocked.add(v)
            blocked.update(r.adj[v])
        else:
            r.status[v] = EXCLUDED
    members = r.reconstruct()
    assert g.is_independent_set(members)
    return g.set_weight(members), members
