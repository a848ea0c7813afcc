"""Local reduction phase (§5.1): exhaustive fixed-order rule application.

Port of :mod:`repro.core.local_reduce`.  Rules sweep until no rule fires;
all scheduled cheap families run per sweep, and Distributed Heavy Vertex
(the expensive exact-sub-MWIS rule) runs only on sweeps where the cheap
families made no progress.  The reference's ``lax.while_loop`` /
``lax.cond`` become host loops that read the device ``changed`` flag, with
the same semantics (``changed`` starts True, body first, then the test), so
the sweep count matches the reference exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as E
from repro_torch.core import rules as R
from repro_torch.core.partition import PartitionedGraph


def make_aux(pg: PartitionedGraph, pe: int,
             device: torch.device | str = "cpu") -> R.Aux:
    """The static Aux of one PE's local subgraph on ``device``."""

    def take(a):
        return torch.from_numpy(np.ascontiguousarray(a[pe])).to(device)

    return R.Aux(
        row=take(pg.row), col=take(pg.col), gid=take(pg.gid),
        is_local=take(pg.is_local), is_iface=take(pg.is_iface),
        owner_rank=take(pg.owner_pe),
        window=take(pg.window), win_complete=take(pg.win_complete),
        win_adj_bits=take(pg.win_adj_bits), edge_common=take(pg.edge_common),
    )


def local_reduce(
    state: R.RedState,
    aux: R.Aux,
    *,
    heavy_k: int = 8,
    use_heavy: bool = True,
    max_sweeps: int = 10_000,
    schedule: str = "cheap",
    backend: str = "torch",
    plan: Optional[E.SegPlan] = None,
) -> R.RedState:
    """Run rule sweeps to the local fixpoint (or ``max_sweeps`` sweeps)."""
    changed, it = True, 0
    while changed and it < max_sweeps:
        state = state._replace(changed=torch.zeros_like(state.changed))
        state = E.sweep(
            state, aux, schedule=schedule, backend=backend, plan=plan
        )
        changed = bool(state.changed)
        if use_heavy and not changed:
            state = R.rule_heavy_vertex(state, aux, heavy_k)
            changed = bool(state.changed)
        it += 1
    return state


def reduce_single_pe(
    pg: PartitionedGraph, *, heavy_k: int = 8, use_heavy: bool = True,
    schedule: str = "cheap", backend: str = "torch",
    r_blk: int | None = None, device: torch.device | str | None = None,
) -> Tuple[R.RedState, R.Aux]:
    """Single-PE (p must be 1) reduction — the sequential-semantics entry
    point and the p=1 baseline."""
    if pg.p != 1:
        raise ValueError("reduce_single_pe expects an unpartitioned graph")
    dev = resolve_device(device)
    aux = make_aux(pg, 0, dev)
    plan = None if backend == "torch" else E.build_plan(
        pg.row[0], pg.V, r_blk=r_blk,
        col=pg.col[0], gid=pg.gid[0], window=pg.window[0],
        win_adj_bits=pg.win_adj_bits[0], device=dev,
    )

    def take(a):
        return torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)

    state = R.init_state(take(pg.w0), take(pg.is_local), take(pg.is_ghost))
    state = local_reduce(
        state, aux, heavy_k=heavy_k, use_heavy=use_heavy,
        schedule=schedule, backend=backend, plan=plan,
    )
    return state, aux
