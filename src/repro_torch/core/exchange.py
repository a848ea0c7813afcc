"""Border exchange — §5.2 "Communicating Reduction Progress", union layout.

Port of the union half of :mod:`repro.core.exchange`.  Two message types,
as the paper defines them: (1) weight decrease — interface weights are
re-published so ghost copies stay valid upper bounds (Lemma 4.2); (2) vertex
status — excluded / proposed-to-include updates, with the Lemma 4.4/4.5
rank tie-breaking for conflicting include proposals.

In the union layout all PEs are stacked into one block-diagonal graph on a
single device, so the all-gather of interface *boards* is plain indexing
across the stacked [p, ...] halo.  The per-PE layout over
``torch.distributed`` collectives is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import rules as R
from repro_torch.core.partition import PartitionedGraph

UNDECIDED, INCLUDED, EXCLUDED, FOLDED = 0, 1, 2, 3
I32 = torch.int32
I8 = torch.int8
I32_MAX = torch.iinfo(torch.int32).max


class Halo(NamedTuple):
    """Halo routing, stacked [p, ...] for the union layout."""

    iface_slots: torch.Tensor       # [p, B] union idx of board slots (pad = p*V)
    ghost_vertex: torch.Tensor      # [p, G] union vertex index of each ghost
    ghost_owner_pe: torch.Tensor    # [p, G] rank owning the ghost (pad = 0)
    ghost_owner_slot: torch.Tensor  # [p, G] slot in owner's board (pad = 0)
    ghost_valid: torch.Tensor       # [p, G] bool
    send_slot: torch.Tensor         # [p, p, S] board slots per destination
    recv_ghost: torch.Tensor        # [p, p, S] ghost slot per source


def make_halo(pg: PartitionedGraph,
              device: torch.device | str = "cpu") -> Halo:
    """Stacked [p, ...] halo with union vertex offsets."""
    L, G, V = pg.L, pg.G, pg.V
    off = (np.arange(pg.p, dtype=np.int64) * V)[:, None]
    iface = np.where(pg.iface_slots < pg.nil, pg.iface_slots + off, pg.p * V)
    gvert = off + L + np.arange(G)[None, :]

    def dev(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return Halo(
        iface_slots=dev(iface),
        ghost_vertex=dev(gvert),
        ghost_owner_pe=dev(np.maximum(pg.owner_pe[:, L : L + G], 0)),
        ghost_owner_slot=dev(pg.ghost_owner_slot),
        ghost_valid=dev(pg.is_ghost[:, L : L + G], bool),
        send_slot=dev(pg.send_slot),
        recv_ghost=dev(pg.recv_ghost),
    )


# --------------------------------------------------------------------- #
# reconcile: apply (gw, gs) ghost updates + include-conflict tie-breaking
# --------------------------------------------------------------------- #
def reconcile(
    state: R.RedState,
    aux: R.Aux,
    ghost_vertex: torch.Tensor,
    ghost_valid: torch.Tensor,
    gw: torch.Tensor,
    gs: torch.Tensor,
    *,
    backend: str = "torch",
    plan: Optional[E.SegPlan] = None,
) -> Tuple[R.RedState, torch.Tensor]:
    """Apply board-derived ghost weight/status updates.

    Conflicting include proposals across a cut edge can only be the
    isolated-equal-weight-edge case (Lemma 4.4); both sides deterministically
    keep the endpoint owned by the *smaller* rank (Lemma 4.5).
    Returns (state, changed).  Both conflict reductions are keyed by
    ``aux.row``, so they route through the same aggregate backend as the
    rule aggregates."""
    V = state.w.shape[0]
    nilv = V - 1
    dev = state.w.device

    # Scatter board values into V-sized arrays (ghost slots only; invalid
    # ghosts all write the same fill value onto the nil slot).
    tgt = torch.where(ghost_valid, ghost_vertex, nilv)
    bw = torch.full((V,), I32_MAX, dtype=I32, device=dev)
    bw[tgt] = torch.where(ghost_valid, gw, I32_MAX).to(I32)
    bs = torch.full((V,), -1, dtype=I32, device=dev)
    bs[tgt] = torch.where(ghost_valid, gs.to(I32), -1)

    status = state.status
    rank_r = aux.owner_rank[aux.row]
    rank_c = aux.owner_rank[aux.col]

    # --- include-proposal conflicts over cut edges -------------------- #
    ghost_inc = bs == INCLUDED                       # [V] board says included
    prop_local = (status == INCLUDED) & aux.is_iface
    # (a) local proposal v = row loses iff a proposing ghost neighbor's
    #     owner has the smaller rank
    v_lose_e = (
        prop_local[aux.row] & ghost_inc[aux.col]
        & (aux.gid[aux.col] >= 0) & (rank_c < rank_r)
    )
    # (b) the ghost's proposal u = row loses iff our local proposal has the
    #     smaller rank
    u_lose_e = (
        ghost_inc[aux.row] & prop_local[aux.col]
        & (aux.gid[aux.row] >= 0) & (rank_c < rank_r)
    )
    _, losses, _, _ = E.aggregate(
        aux.row, V,
        data_max=torch.stack([v_lose_e, u_lose_e], dim=1).to(I32),
        backend=backend, plan=plan,
    )
    v_lose = losses[:, 0] > 0
    u_lose = losses[:, 1] > 0
    status = torch.where(v_lose & (status == INCLUDED), EXCLUDED, status)
    status = status.to(I8)

    # --- ghost status update ------------------------------------------ #
    is_ghost_slot = bs >= 0
    new_ghost = torch.where(
        (bs == INCLUDED) & ~u_lose,
        INCLUDED,
        torch.where(
            (bs == EXCLUDED) | (bs == FOLDED) | ((bs == INCLUDED) & u_lose),
            EXCLUDED,
            status.to(I32),  # owner still UNDECIDED: keep local view
        ),
    )
    status2 = torch.where(is_ghost_slot, new_ghost.to(I8), status)

    # --- weight decrease (owner is authoritative; monotone) ------------ #
    w2 = torch.where(is_ghost_slot, torch.minimum(state.w, bw), state.w)

    # --- exclude local active neighbors of newly-included ghosts ------- #
    ginc_now = is_ghost_slot & (status2 == INCLUDED)
    _, hit_m, _, _ = E.aggregate(
        aux.row, V, data_max=ginc_now[aux.col].to(I32),
        backend=backend, plan=plan,
    )
    status3 = torch.where(
        (hit_m > 0) & (status2 == UNDECIDED) & aux.is_local,
        EXCLUDED, status2,
    ).to(I8)

    changed = (status3 != state.status).any() | (w2 != state.w).any()
    return state._replace(w=w2, status=status3), changed


# --------------------------------------------------------------------- #
# union boards
# --------------------------------------------------------------------- #
def _board(state: R.RedState,
           iface_slots: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Board values; padded slots index nil → weight 0 / EXCLUDED (ignored
    because padded ghosts are invalid on the receiving side)."""
    return state.w[iface_slots], state.status[iface_slots]


def union_boards(
    state: R.RedState, halo: Halo
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every PE's published interface board in the union layout: the
    message each PE *would* put on the wire this round, both [p, B]."""
    # halo.iface_slots pads with p*V, one past the end: clamp onto the
    # union nil slot (JAX clamps out-of-range gathers; torch raises)
    nil_u = state.w.shape[0] - 1
    return _board(state, halo.iface_slots.clamp(max=nil_u))


def reconcile_union_boards(
    state: R.RedState, aux: R.Aux, halo: Halo,
    boards_w: torch.Tensor, boards_s: torch.Tensor, *,
    backend: str = "torch", plan: Optional[E.SegPlan] = None,
) -> Tuple[R.RedState, torch.Tensor]:
    """Apply a full [p, B] board set (possibly stale) to the union state."""
    pe, slot = halo.ghost_owner_pe.long(), halo.ghost_owner_slot.long()
    gw = boards_w[pe, slot]  # [p, G]
    gs = boards_s[pe, slot]
    return reconcile(
        state, aux,
        halo.ghost_vertex.reshape(-1),
        halo.ghost_valid.reshape(-1),
        gw.reshape(-1), gs.reshape(-1),
        backend=backend, plan=plan,
    )


def exchange_union(
    state: R.RedState, aux: R.Aux, halo: Halo, *,
    backend: str = "torch", plan: Optional[E.SegPlan] = None,
) -> Tuple[R.RedState, torch.Tensor]:
    """Union-layout exchange: 'collectives' are plain indexing across the
    stacked [p, ...] halo (single-device simulation of the SPMD program)."""
    boards_w, boards_s = union_boards(state, halo)
    return reconcile_union_boards(
        state, aux, halo, boards_w, boards_s, backend=backend, plan=plan,
    )
