"""Graph instance generators — KaGen stand-ins for the paper's weak-scaling set.

The paper's weak-scaling experiments (§7) use three families generated with
KaGen [17]:

  * GNM — Erdős–Rényi G(n, m): barely reducible (Table C.4: |V'|/|V| = 0.98),
  * RGG — 2D random geometric: reduces to ~34 %,
  * RHG — random hyperbolic, power-law γ = 2.8: reduces to ≈ 0.01 %.

These reproduce the *qualitative reduction-impact spread* that drives the
paper's evaluation.  All generators are deterministic in `seed` and return
:class:`repro_torch.core.graph.Graph` with uniform random integer weights in
[1, 200] (the paper's weight model, Table C.1 'uf [1, 200]').
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, from_edge_list

WEIGHT_LO, WEIGHT_HI = 1, 200


def _weights(n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(WEIGHT_LO, WEIGHT_HI + 1, size=n, dtype=np.int32)


def gnm(n: int, m: int, seed: int = 0) -> Graph:
    """Erdős–Rényi G(n, m) — uniform random edge set without replacement."""
    rng = np.random.default_rng(seed)
    # Rejection-free sampling of undirected pairs: sample with margin, dedup.
    want = m
    pairs = np.zeros((0, 2), dtype=np.int64)
    attempts = 0
    while pairs.shape[0] < want and attempts < 64:
        k = int((want - pairs.shape[0]) * 1.4) + 16
        u = rng.integers(0, n, size=k, dtype=np.int64)
        v = rng.integers(0, n, size=k, dtype=np.int64)
        keep = u != v
        lo = np.minimum(u[keep], v[keep])
        hi = np.maximum(u[keep], v[keep])
        cand = np.stack([lo, hi], axis=1)
        pairs = np.unique(np.concatenate([pairs, cand], axis=0), axis=0)
        attempts += 1
    pairs = pairs[:want]
    return from_edge_list(n, pairs, _weights(n, rng))


def rgg2d(n: int, radius: float | None = None, *, avg_deg: float = 8.0,
          seed: int = 0) -> Graph:
    """2D random geometric graph on the unit square (grid-bucketed O(n))."""
    rng = np.random.default_rng(seed)
    if radius is None:
        # E[deg] = n * pi * r^2  =>  r = sqrt(avg_deg / (pi n))
        radius = float(np.sqrt(avg_deg / (np.pi * n)))
    pts = rng.random((n, 2))
    # Spatially coherent vertex ids (sort by grid cell), matching KaGen's
    # per-PE generation: contiguous 1D blocks then correspond to spatial
    # regions, as in the paper's distributed inputs.
    _nc = max(1, int(1.0 / max(radius, 1e-9)))
    _cx = np.minimum((pts[:, 0] / max(radius, 1e-9)).astype(np.int64), _nc - 1)
    _cy = np.minimum((pts[:, 1] / max(radius, 1e-9)).astype(np.int64), _nc - 1)
    pts = pts[np.argsort(_cx * _nc + _cy, kind="stable")]
    cell = max(radius, 1e-9)
    ncell = max(1, int(1.0 / cell))
    cx = np.minimum((pts[:, 0] / cell).astype(np.int64), ncell - 1)
    cy = np.minimum((pts[:, 1] / cell).astype(np.int64), ncell - 1)
    cid = cx * ncell + cy
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    starts = np.searchsorted(sorted_cid, np.arange(ncell * ncell))
    ends = np.searchsorted(sorted_cid, np.arange(ncell * ncell), side="right")

    src_list, dst_list = [], []
    r2 = radius * radius
    for gx in range(ncell):
        for gy in range(ncell):
            mine = order[starts[gx * ncell + gy]: ends[gx * ncell + gy]]
            if mine.size == 0:
                continue
            # neighbors: same + 4 forward cells (avoid double counting)
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1), (1, -1)):
                nx, ny = gx + dx, gy + dy
                if not (0 <= nx < ncell and 0 <= ny < ncell):
                    continue
                other = order[starts[nx * ncell + ny]: ends[nx * ncell + ny]]
                if other.size == 0:
                    continue
                d = pts[mine, None, :] - pts[None, other, :]
                close = (d * d).sum(-1) <= r2
                ii, jj = np.nonzero(close)
                uu, vv = mine[ii], other[jj]
                if dx == 0 and dy == 0:
                    keep = uu < vv
                    uu, vv = uu[keep], vv[keep]
                src_list.append(uu)
                dst_list.append(vv)
    if src_list:
        src = np.concatenate(src_list)
        dst = np.concatenate(dst_list)
        pairs = np.stack([src, dst], axis=1)
    else:
        pairs = np.zeros((0, 2), dtype=np.int64)
    return from_edge_list(n, pairs, _weights(n, rng))


def rhg(n: int, avg_deg: float = 8.0, gamma: float = 2.8,
        seed: int = 0) -> Graph:
    """True random hyperbolic graph (threshold model, exact O(n²) pairing —
    test/bench scale).  Points in the hyperbolic disk (radial density
    ~ e^{αr} with α = (γ−1)/2, uniform angle); vertices adjacent iff their
    hyperbolic distance is below a threshold picked to hit `avg_deg`
    exactly.  This reproduces the power-law degrees AND the hierarchical
    clustering that make the paper's RHG instances collapse under
    reductions (Table C.4).  Ids sorted by angle (KaGen-style locality).
    """
    rng = np.random.default_rng(seed)
    alpha = (gamma - 1.0) / 2.0
    R0 = 2.0 * np.log(n)
    u = rng.random(n)
    r = np.arccosh(1.0 + u * (np.cosh(alpha * R0) - 1.0)) / alpha
    theta = np.sort(rng.random(n) * 2 * np.pi)  # angular-sorted ids
    m_target = int(avg_deg * n / 2)

    # pairwise hyperbolic distances, chunked; threshold at the m-th smallest
    ch = np.cosh(r)
    sh = np.sinh(r)
    dists = []
    pairs_i = []
    pairs_j = []
    step = max(1, 2_000_000 // max(n, 1))
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        ii = np.arange(i0, i1)
        cosd = (
            ch[ii, None] * ch[None, :]
            - sh[ii, None] * sh[None, :] * np.cos(
                theta[ii, None] - theta[None, :]
            )
        )
        d = np.arccosh(np.maximum(cosd, 1.0))
        jj = np.arange(n)
        mask = jj[None, :] > ii[:, None]
        sel_i, sel_j = np.nonzero(mask)
        dd = d[sel_i, sel_j]
        keep = dd <= R0  # pre-filter to keep memory bounded
        dists.append(dd[keep])
        pairs_i.append(ii[sel_i][keep])
        pairs_j.append(jj[sel_j][keep])
    dd = np.concatenate(dists)
    pi = np.concatenate(pairs_i)
    pj = np.concatenate(pairs_j)
    if dd.shape[0] > m_target:
        thr = np.partition(dd, m_target - 1)[m_target - 1]
        keep = dd <= thr
        pi, pj = pi[keep], pj[keep]
    pairs = np.stack([pi, pj], axis=1)
    return from_edge_list(n, pairs, _weights(n, rng))


def rhg_like(n: int, avg_deg: float = 8.0, gamma: float = 2.8,
             seed: int = 0) -> Graph:
    """Power-law graph (Chung–Lu) standing in for KaGen's random hyperbolic
    generator: degree distribution ~ k^-gamma, strong local clustering is NOT
    modelled, but the reduction-relevant property — a heavy-tailed degree
    sequence with a vast low-degree periphery — is.
    """
    rng = np.random.default_rng(seed)
    # Chung-Lu with a power-law degree sequence P(k) ~ k^-gamma, k >= 1:
    # inverse-CDF sampling gives the RHG-like shape — a vast degree-1/2
    # periphery plus heavy hubs — which is what drives the near-total
    # reducibility of RHG instances in the paper (Table C.4).
    u = rng.random(n)
    wts = (1.0 - u) ** (-1.0 / (gamma - 1.0))      # Pareto(k_min=1)
    wts = np.minimum(wts, np.sqrt(n))              # hub cutoff
    wts *= (avg_deg * n) / wts.sum()
    wts = np.sort(wts)[::-1]                       # hubs first (locality)
    total = wts.sum()
    m = int(avg_deg * n / 2)
    p = wts / total
    u = rng.choice(n, size=2 * m, p=p)
    v = rng.choice(n, size=2 * m, p=p)
    keep = u != v
    pairs = np.stack([u[keep], v[keep]], axis=1)[:m]
    g = from_edge_list(n, pairs, _weights(n, rng))
    return g


def random_graph(n: int, p_edge: float, seed: int = 0) -> Graph:
    """Dense-ish uniform random graph (tests / brute-force oracles)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    mask = rng.random(iu[0].shape[0]) < p_edge
    pairs = np.stack([iu[0][mask], iu[1][mask]], axis=1)
    return from_edge_list(n, pairs, _weights(n, rng))


def path_graph(n: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    pairs = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return from_edge_list(n, pairs, _weights(n, rng))


def star_graph(n_leaves: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    pairs = np.stack(
        [np.zeros(n_leaves, dtype=np.int64), np.arange(1, n_leaves + 1)], axis=1
    )
    return from_edge_list(n_leaves + 1, pairs, _weights(n_leaves + 1, rng))


FAMILIES = {
    "gnm": lambda n, seed=0: gnm(n, 4 * n, seed=seed),
    "rgg": lambda n, seed=0: rgg2d(n, avg_deg=8.0, seed=seed),
    "rhg": lambda n, seed=0: rhg(n, avg_deg=8.0, seed=seed),
}
