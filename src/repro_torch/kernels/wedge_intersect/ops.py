"""Public API of the capped-window machinery.

  * :func:`common_neighbor_stats` — weighted / active window intersection
    per edge (the single-edge rules' C and K): CUDA tensors launch the
    hand-written kernel (:mod:`repro_torch.kernels.wedge_intersect.kernel`),
    CPU tensors take its plain version;
  * :func:`window_active_bits` / :func:`window_clique_ok` — the
    fresh-status activity and clique predicates, plain torch, used by rule
    *applications* and by the engine's ``torch`` backend; the blocked
    backends compute the same bits through the fused edge pass (static
    window-position payloads in the SegPlan — see
    :mod:`repro_torch.core.engine`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import device_kind
from repro_torch.kernels.wedge_intersect import kernel as K
from repro_torch.kernels.wedge_intersect.ref import common_neighbor_stats_ref


def common_neighbor_stats(
    window: torch.Tensor,    # [V, D] capped neighbor lists (nil padded)
    weights: torch.Tensor,   # [V] current weights
    active: torch.Tensor,    # [V] bool
    row: torch.Tensor,       # [E]
    col: torch.Tensor,       # [E]
):
    """(C[e], K[e]) = weighted / active common-neighborhood per edge, two
    [E] int32 tensors.

    Entries are drawn from W(row); membership is tested against W(col), so
    the result is the capped lower bound the single-edge rules require.
    CUDA tensors launch the kernel (int32 windows, weights and edges, width
    up to 32), CPU tensors take the plain torch version; another device or
    a mix raises.  Indices are taken to be valid vertices."""
    if device_kind("common_neighbor_stats", window, weights, active, row,
                   col) == "cuda":
        return K.wedge_intersect(window, weights, active, row, col)
    return common_neighbor_stats_ref(window, weights, active, row, col)


def window_active_bits(
    active: torch.Tensor,   # [V] bool (status == UNDECIDED)
    gid: torch.Tensor,      # [V] i32 global ids (pad/nil = -1)
    window: torch.Tensor,   # [V, D] capped neighbor lists
) -> torch.Tensor:
    """[V] i32 — bit i set iff window[v, i] is an active real vertex.
    Bits are disjoint per position, so the OR is a plain sum."""
    D = window.shape[1]
    idx = window.long()
    ent_ok = active[idx] & (gid[idx] >= 0)                      # [V, D]
    shifts = torch.arange(D, dtype=torch.int32, device=window.device)
    return (ent_ok.to(torch.int32) << shifts).sum(dim=1, dtype=torch.int32)


def window_clique_ok(
    act_bits: torch.Tensor,      # [V] i32 window activity bits
    win_adj_bits: torch.Tensor,  # [V, D] i32 static pairwise adjacency bits
) -> torch.Tensor:
    """[V] bool — do the *active* window entries form a clique?

    Exact when win_complete (window = full static neighbor list); the caller
    must gate on win_complete.  Ghost pairs have no stored edge, so ≥2
    active ghost neighbors naturally fail — matching "a clique in G_i
    contains at most one ghost"."""
    D = win_adj_bits.shape[1]
    shifts = torch.arange(D, dtype=torch.int32, device=act_bits.device)
    active_i = ((act_bits[:, None] >> shifts) & 1) == 1          # [V, D]
    need = act_bits[:, None] & ~(torch.ones_like(shifts) << shifts)
    bad = active_i & ((need & ~win_adj_bits) != 0)
    return ~bad.any(dim=1)
