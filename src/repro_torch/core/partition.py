"""1D vertex partition with ghost halos — the paper's machine model (§3).

Each PE i owns a contiguous block of vertices ``V_i`` (balanced by vertex
count or by edge count).  The local subgraph ``G_i`` contains:

  * all directed edges (u → v) with u ∈ V_i  (targets may be *ghosts*),
  * the reversed cut edges (ghost → local), i.e. the replicated local part
    ``N(g) ∩ V_i`` of every ghost's neighborhood — exactly what the paper
    replicates,
  * replicated ghost weights (upper bounds during reduction, Lemma 4.2).

SPMD adaptation: every per-PE array is padded to the maximum size over
PEs and stacked into a leading ``[p, ...]`` axis consumed by ``shard_map``.
A dedicated NIL vertex (local index ``L + G``) absorbs padding: weight 0,
status EXCLUDED, so masked segment ops ignore it without branches.

Halo routing is precomputed host-side:

  * board layout  — every PE publishes its interface vertices in a fixed
    order (`iface_slots`); ghosts address their owner's board via
    ``(ghost_owner_pe, ghost_owner_slot)``.  The baseline exchange is an
    ``all_gather`` of boards.
  * all_to_all routing — padded per-destination send lists
    (``send_slot``) and receive scatter lists (``recv_ghost``) for the
    bandwidth-optimal exchange (see EXPERIMENTS.md §Perf).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import validate as VAL
from repro_torch.core.graph import Graph

# Status codes shared with the rules.
UNDECIDED, INCLUDED, EXCLUDED, FOLDED = 0, 1, 2, 3


@dataclasses.dataclass
class PartitionedGraph:
    """Host-side partitioned graph; arrays stacked over the PE axis."""

    p: int
    n_global: int
    L: int  # padded local vertex count
    G: int  # padded ghost count
    E: int  # padded directed edge count (local rows + reversed cut edges)
    B: int  # padded interface-board size
    S: int  # padded per-destination send-list size (all_to_all exchange)
    D: int  # neighbor-window cap for capped rules

    starts: np.ndarray          # [p+1] block boundaries (global ids)
    row: np.ndarray             # [p, E] int32 local source index (pad = nil)
    col: np.ndarray             # [p, E] int32 local target index (pad = nil)
    w0: np.ndarray              # [p, V] int32 initial weights (V = L+G+1)
    gid: np.ndarray             # [p, V] int32 global id (pad/nil = -1)
    is_local: np.ndarray        # [p, V] bool
    is_ghost: np.ndarray        # [p, V] bool
    is_iface: np.ndarray        # [p, V] bool (local & has ghost neighbor)
    deg_local: np.ndarray       # [p, V] int32 (#edges with this row; exact
                                #  for locals, partial for ghosts)
    owner_pe: np.ndarray        # [p, V] int32 owning PE (self for locals)
    iface_slots: np.ndarray     # [p, B] int32 local idx of board slot (pad=nil)
    ghost_owner_slot: np.ndarray  # [p, G] int32 slot in owner board (pad=0)
    window: np.ndarray          # [p, V, D] int32 capped neighbor lists (pad=nil)
    win_complete: np.ndarray    # [p, V] bool (window holds the FULL PE-local
                                #  neighbor list)
    win_adj_bits: np.ndarray    # [p, V, D] int32 — bit j of [v, i] set iff
                                #  window[v, i] and window[v, j] are adjacent
                                #  (exact static adjacency; edges are never
                                #  inserted so this stays valid under masking)
    edge_common: np.ndarray     # [p, E, Dc] int32 — capped static common
                                #  neighborhood of each edge's endpoints
                                #  (lower-bound semantics for single-edge rules)
    Dc: int
    send_slot: np.ndarray       # [p, p, S] int32 board slots to send (pad=B)
    recv_ghost: np.ndarray      # [p, p, S] int32 ghost idx to scatter (pad=G)

    @property
    def V(self) -> int:
        return self.L + self.G + 1

    @property
    def nil(self) -> int:
        return self.L + self.G

    def local_of_global(self, pe: int, g: int) -> int:
        return int(g - self.starts[pe])

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The arrays the jitted reduction consumes (stacked over PEs)."""
        return dict(
            row=self.row, col=self.col, w0=self.w0, gid=self.gid,
            is_local=self.is_local, is_ghost=self.is_ghost,
            is_iface=self.is_iface, owner_pe=self.owner_pe,
            iface_slots=self.iface_slots,
            ghost_owner_slot=self.ghost_owner_slot,
            window=self.window, win_complete=self.win_complete,
            win_adj_bits=self.win_adj_bits, edge_common=self.edge_common,
            send_slot=self.send_slot, recv_ghost=self.recv_ghost,
        )


def _block_starts(g: Graph, p: int, edge_balanced: bool) -> np.ndarray:
    n = g.n
    if not edge_balanced:
        base = np.linspace(0, n, p + 1).astype(np.int64)
        return base
    # Edge-balanced contiguous split: cut points at equal shares of 2m.
    cum = g.indptr
    total = cum[-1]
    targets = np.linspace(0, total, p + 1)
    starts = np.searchsorted(cum, targets, side="left")
    starts[0], starts[-1] = 0, n
    starts = np.maximum.accumulate(starts)
    return starts.astype(np.int64)


def partition_graph(
    g: Graph,
    p: int,
    *,
    edge_balanced: bool = True,
    window_cap: int = 16,
    common_cap: int = 4,
    min_pad: int = 4,
    pad_to: Optional[Dict[str, int]] = None,
) -> PartitionedGraph:
    """`pad_to` (keys among L/G/E/B/S) forces minimum padded sizes so that
    different instances share one compiled program (shape bucketing)."""
    n = g.n
    starts = _block_starts(g, p, edge_balanced)
    src_all = g.edge_sources()

    per_pe = []
    for i in range(p):
        lo, hi = int(starts[i]), int(starts[i + 1])
        nloc = hi - lo
        e0, e1 = int(g.indptr[lo]), int(g.indptr[hi])
        esrc = src_all[e0:e1].astype(np.int64)
        edst = g.indices[e0:e1].astype(np.int64)
        remote = (edst < lo) | (edst >= hi)
        ghosts = np.unique(edst[remote])
        gmap = {int(gg): k for k, gg in enumerate(ghosts)}
        ngh = ghosts.shape[0]

        def loc(ids: np.ndarray) -> np.ndarray:
            out = np.empty(ids.shape[0], dtype=np.int64)
            inside = (ids >= lo) & (ids < hi)
            out[inside] = ids[inside] - lo
            out[~inside] = np.array(
                [nloc + gmap[int(x)] for x in ids[~inside]], dtype=np.int64
            ) if (~inside).any() else out[~inside]
            return out

        lsrc = esrc - lo
        ldst = loc(edst)
        # reversed cut edges: ghost -> local  (the replicated N(g) ∩ V_i)
        cut = ldst >= nloc
        rev_src = ldst[cut]
        rev_dst = lsrc[cut]
        rows = np.concatenate([lsrc, rev_src])
        cols = np.concatenate([ldst, rev_dst])
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]

        iface = np.zeros(nloc, dtype=bool)
        iface[lsrc[cut]] = True
        per_pe.append(
            dict(lo=lo, hi=hi, nloc=nloc, ghosts=ghosts, rows=rows,
                 cols=cols, iface=iface)
        )

    pad = pad_to or {}
    L = max(max((d["nloc"] for d in per_pe), default=1), 1, pad.get("L", 0))
    Gm = max(max((d["ghosts"].shape[0] for d in per_pe), default=0), min_pad,
             pad.get("G", 0))
    Em = max(max((d["rows"].shape[0] for d in per_pe), default=0), min_pad,
             pad.get("E", 0))
    Bm = max(max((int(d["iface"].sum()) for d in per_pe), default=0), min_pad,
             pad.get("B", 0))
    D = window_cap
    nil = L + Gm
    V = nil + 1

    row = np.full((p, Em), nil, dtype=np.int32)
    col = np.full((p, Em), nil, dtype=np.int32)
    w0 = np.zeros((p, V), dtype=np.int32)
    gid = np.full((p, V), -1, dtype=np.int32)
    is_local = np.zeros((p, V), dtype=bool)
    is_ghost = np.zeros((p, V), dtype=bool)
    is_iface = np.zeros((p, V), dtype=bool)
    deg_local = np.zeros((p, V), dtype=np.int32)
    owner_pe = np.full((p, V), -1, dtype=np.int32)
    iface_slots = np.full((p, Bm), nil, dtype=np.int32)
    ghost_owner_slot = np.zeros((p, Gm), dtype=np.int32)
    window = np.full((p, V, D), nil, dtype=np.int32)
    win_complete = np.zeros((p, V), dtype=bool)

    owner_of = np.searchsorted(starts, np.arange(n), side="right") - 1

    # First pass: fill per-PE vertex/edge arrays + boards.
    board_slot_of = []  # per PE: {global_id -> slot}
    for i, d in enumerate(per_pe):
        nloc, ghosts = d["nloc"], d["ghosts"]
        ne = d["rows"].shape[0]
        row[i, :ne] = d["rows"]
        col[i, :ne] = d["cols"]
        gids_local = np.arange(d["lo"], d["hi"], dtype=np.int32)
        gid[i, :nloc] = gids_local
        gid[i, L : L + ghosts.shape[0]] = ghosts.astype(np.int32)
        # remap ghost indices from nloc.. to L..
        shift = (d["rows"] >= nloc)
        row[i, :ne][shift] += L - nloc
        shift = (d["cols"] >= nloc)
        col[i, :ne][shift] += L - nloc
        w0[i, :nloc] = g.weights[d["lo"] : d["hi"]]
        w0[i, L : L + ghosts.shape[0]] = g.weights[ghosts]
        is_local[i, :nloc] = True
        is_ghost[i, L : L + ghosts.shape[0]] = True
        is_iface[i, :nloc] = d["iface"]
        owner_pe[i, :nloc] = i
        owner_pe[i, L : L + ghosts.shape[0]] = owner_of[ghosts]
        deg_local[i] = np.bincount(row[i, :ne], minlength=V).astype(np.int32)
        slots = np.flatnonzero(d["iface"])
        iface_slots[i, : slots.shape[0]] = slots
        board_slot_of.append(
            {int(gids_local[s]): k for k, s in enumerate(slots)}
        )
        # neighbor windows (first D neighbors in sorted col order per row)
        rr, cc = row[i, :ne], col[i, :ne]
        pos_in_row = np.zeros(ne, dtype=np.int64)
        if ne:
            newrow = np.ones(ne, dtype=bool)
            newrow[1:] = rr[1:] != rr[:-1]
            idx_start = np.zeros(V + 1, dtype=np.int64)
            uniq, cnt = np.unique(rr, return_counts=True)
            # position within row
            cs = np.cumsum(np.concatenate([[0], cnt]))
            starts_of_row = dict(zip(uniq.tolist(), cs[:-1].tolist()))
            pos_in_row = np.arange(ne) - np.array(
                [starts_of_row[int(x)] for x in rr]
            )
            small = pos_in_row < D
            window[i, rr[small], pos_in_row[small]] = cc[small]
        win_complete[i] = deg_local[i] <= D

    # Static window-pair adjacency bitmasks + capped per-edge common lists.
    Dc = common_cap
    win_adj_bits = np.zeros((p, V, D), dtype=np.int32)
    edge_common = np.full((p, Em, Dc), nil, dtype=np.int32)
    for i, d in enumerate(per_pe):
        ne = d["rows"].shape[0]
        rr, cc = row[i, :ne].astype(np.int64), col[i, :ne].astype(np.int64)
        keys = np.sort(rr * V + cc)

        def has_edge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
            if keys.shape[0] == 0:
                return np.zeros(a.shape, dtype=bool)
            q = a * V + b
            pos = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
            return (keys[pos] == q) & (a != nil) & (b != nil)

        wnd = window[i].astype(np.int64)  # [V, D]
        for a_i in range(D):
            for b_i in range(D):
                if a_i == b_i:
                    continue
                adj = has_edge(wnd[:, a_i], wnd[:, b_i])
                win_adj_bits[i, :, a_i] |= adj.astype(np.int32) << b_i
        # Per-edge capped common neighborhood: window(u) ∩ window(v).
        if ne:
            wu = wnd[rr]          # [ne, D]
            wv = wnd[cc]          # [ne, D]
            # membership of wu entries in wv rows
            is_common = (wu[:, :, None] == wv[:, None, :]).any(-1)
            is_common &= wu != nil
            # take first Dc common entries
            rank = np.cumsum(is_common, axis=1) - 1
            sel = is_common & (rank < Dc)
            e_idx, k_idx = np.nonzero(sel)
            edge_common[i, e_idx, rank[sel]] = wu[sel].astype(np.int32)

    # Second pass: ghost -> owner board slots.
    for i, d in enumerate(per_pe):
        for k, gg in enumerate(d["ghosts"].tolist()):
            o = int(owner_of[gg])
            ghost_owner_slot[i, k] = board_slot_of[o][int(gg)]

    # all_to_all routing: PE i sends to PE j the boards entries of interface
    # vertices that are ghosts on j (sorted by gid for a canonical order).
    send_lists = [[[] for _ in range(p)] for _ in range(p)]
    recv_lists = [[[] for _ in range(p)] for _ in range(p)]
    for j, d in enumerate(per_pe):  # j = receiving PE (owns the ghosts)
        for k, gg in enumerate(d["ghosts"].tolist()):
            o = int(owner_of[gg])  # o = sending PE (owns vertex gg)
            send_lists[o][j].append(board_slot_of[o][int(gg)])
            recv_lists[j][o].append(k)
    Sm = max(
        max((len(send_lists[i][j]) for i in range(p) for j in range(p)),
            default=0),
        1,
        pad.get("S", 0),
    )
    send_slot = np.full((p, p, Sm), Bm, dtype=np.int32)
    recv_ghost = np.full((p, p, Sm), Gm, dtype=np.int32)
    for i in range(p):
        for j in range(p):
            s = send_lists[i][j]
            send_slot[i, j, : len(s)] = s
            r = recv_lists[i][j]
            recv_ghost[i, j, : len(r)] = r

    return PartitionedGraph(
        p=p, n_global=n, L=L, G=Gm, E=Em, B=Bm, S=Sm, D=D,
        starts=starts, row=row, col=col, w0=w0, gid=gid,
        is_local=is_local, is_ghost=is_ghost, is_iface=is_iface,
        deg_local=deg_local, owner_pe=owner_pe, iface_slots=iface_slots,
        ghost_owner_slot=ghost_owner_slot, window=window,
        win_complete=win_complete, win_adj_bits=win_adj_bits,
        edge_common=edge_common, Dc=Dc,
        send_slot=send_slot, recv_ghost=recv_ghost,
    )


def compact_partition(
    pg: PartitionedGraph,
    status: np.ndarray,
    w: np.ndarray,
    *,
    pad_to: Optional[Dict[str, int]] = None,
    min_pad: int = 4,
) -> PartitionedGraph:
    """Exact shape-descent compaction: the *restriction* of ``pg`` to its
    alive (UNDECIDED) kernel, with the current folded weights as ``w0``.

    This is deliberately NOT a fresh :func:`partition_graph` of the
    residual.  The staged solver's bit-identity guarantee rests on the
    restricted instance making every rule test, greedy beat test, peel
    argmax and exchange reconciliation compute exactly the values the
    full-shape run would compute on its alive slots:

      * per-PE ownership is preserved — every alive local/ghost stays on
        its PE, so per-PE peel argmax sets and board routing are unchanged;
      * slot maps are monotone (alive locals keep order, alive ghosts keep
        order, locals stay below ghosts), so the lexsorted edge order — the
        sorted-segment invariant of the aggregate engine — survives verbatim;
      * windows keep their *positions*: dead entries become nil (inactive,
        like any decided vertex) instead of being recomputed, so
        ``win_adj_bits`` copies bit-for-bit and capped-rule activation
        masks match the full-shape run; ``win_complete``/``is_iface`` are
        copied, never recomputed (a fresh partition would fire MORE rules
        than the full-shape run and break parity);
      * global ids are copied (NOT relabelled): rules only compare gids and
        test ``gid >= 0``, so non-contiguous gids are fine — and stitching
        stays a direct lookup in the original id space.

    ``status``/``w`` are the union-layout [p*V] (or [p, V]) arrays of the
    current :class:`repro_torch.core.rules.RedState`.  Requires an
    exchange-consistent state (ghost slot alive iff its owner's copy is
    alive) — true at every post-exchange round boundary; raises
    ``ValueError`` otherwise.  Weights go through
    :func:`repro_torch.core.validate.residual_weights` (the
    ``bad_weight`` gate for folded-weight overflow).  ``pad_to`` keys L/G/E/B/S floor the
    padded sizes (ladder-cell bucketing); actual per-PE maxima win when
    they exceed the floor.
    """
    p, V, L, G = pg.p, pg.V, pg.L, pg.G
    status = np.asarray(status).reshape(p, V)
    w = np.asarray(w).reshape(p, V)
    alive = status == UNDECIDED
    keep_l = pg.is_local & alive
    keep_g = pg.is_ghost & alive
    keep = keep_l | keep_g

    per = []
    for i in range(p):
        kl = np.flatnonzero(keep_l[i])
        kg = np.flatnonzero(keep_g[i])
        ke = np.flatnonzero(keep[i][pg.row[i]] & keep[i][pg.col[i]])
        per.append((kl, kg, ke))

    pad = pad_to or {}
    L2 = max(max(kl.size for kl, _, _ in per), 1, pad.get("L", 0))
    G2 = max(max(kg.size for _, kg, _ in per), min_pad, pad.get("G", 0))
    E2 = max(max(ke.size for _, _, ke in per), min_pad, pad.get("E", 0))
    B2 = max(max(int((keep_l[i] & pg.is_iface[i]).sum()) for i in range(p)),
             min_pad, pad.get("B", 0))
    nil2 = L2 + G2
    V2 = nil2 + 1
    D, Dc = pg.D, pg.Dc

    row = np.full((p, E2), nil2, dtype=np.int32)
    col = np.full((p, E2), nil2, dtype=np.int32)
    w0 = np.zeros((p, V2), dtype=np.int32)
    gid = np.full((p, V2), -1, dtype=np.int32)
    is_local = np.zeros((p, V2), dtype=bool)
    is_ghost = np.zeros((p, V2), dtype=bool)
    is_iface = np.zeros((p, V2), dtype=bool)
    deg_local = np.zeros((p, V2), dtype=np.int32)
    owner_pe = np.full((p, V2), -1, dtype=np.int32)
    iface_slots = np.full((p, B2), nil2, dtype=np.int32)
    window = np.full((p, V2, D), nil2, dtype=np.int32)
    win_complete = np.zeros((p, V2), dtype=bool)
    win_adj_bits = np.zeros((p, V2, D), dtype=np.int32)
    edge_common = np.full((p, E2, Dc), nil2, dtype=np.int32)

    board_slot_of = []  # per PE: {global_id -> new board slot}
    slot_maps = []
    for i, (kl, kg, ke) in enumerate(per):
        smap = np.full(V, nil2, dtype=np.int32)
        smap[kl] = np.arange(kl.size, dtype=np.int32)
        smap[kg] = L2 + np.arange(kg.size, dtype=np.int32)
        slot_maps.append(smap)
        old = np.concatenate([kl, kg])
        new = smap[old]
        # monotone map ⇒ the kept subsequence of the lexsorted edge list
        # stays lexsorted after remapping
        ne = ke.size
        row[i, :ne] = smap[pg.row[i, ke]]
        col[i, :ne] = smap[pg.col[i, ke]]
        w0[i, new] = VAL.residual_weights(
            w[i, old], where=f"compact pe{i}")
        gid[i, new] = pg.gid[i, old]
        is_local[i, smap[kl]] = True
        is_ghost[i, smap[kg]] = True
        is_iface[i, new] = pg.is_iface[i, old]
        owner_pe[i, new] = pg.owner_pe[i, old]
        deg_local[i] = np.bincount(
            row[i, :ne], minlength=V2).astype(np.int32)
        window[i, new] = smap[pg.window[i, old]]
        win_complete[i, new] = pg.win_complete[i, old]
        win_adj_bits[i, new] = pg.win_adj_bits[i, old]
        if ne:
            edge_common[i, :ne] = smap[pg.edge_common[i, ke]]
        slots = smap[np.flatnonzero(keep_l[i] & pg.is_iface[i])]
        iface_slots[i, : slots.size] = slots
        board_slot_of.append(
            {int(gid[i, s]): k for k, s in enumerate(slots)}
        )

    # ghost -> owner board routing (old ghost order = sorted by gid).
    ghost_owner_slot = np.zeros((p, G2), dtype=np.int32)
    send_lists = [[[] for _ in range(p)] for _ in range(p)]
    recv_lists = [[[] for _ in range(p)] for _ in range(p)]
    for j, (_, kg, _) in enumerate(per):
        for k2, s in enumerate(kg.tolist()):
            gg = int(pg.gid[j, s])
            o = int(pg.owner_pe[j, s])
            slot = board_slot_of[o].get(gg)
            if slot is None:
                raise ValueError(
                    "compact_partition needs an exchange-consistent state: "
                    f"ghost gid {gg} is alive on pe{j} but its owner copy "
                    f"on pe{o} is not (descend only at post-exchange round "
                    "boundaries)")
            ghost_owner_slot[j, k2] = slot
            send_lists[o][j].append(slot)
            recv_lists[j][o].append(k2)
    S2 = max(
        max((len(send_lists[i][j]) for i in range(p) for j in range(p)),
            default=0),
        1, pad.get("S", 0),
    )
    send_slot = np.full((p, p, S2), B2, dtype=np.int32)
    recv_ghost = np.full((p, p, S2), G2, dtype=np.int32)
    for i in range(p):
        for j in range(p):
            s = send_lists[i][j]
            send_slot[i, j, : len(s)] = s
            r = recv_lists[i][j]
            recv_ghost[i, j, : len(r)] = r

    return PartitionedGraph(
        p=p, n_global=pg.n_global, L=L2, G=G2, E=E2, B=B2, S=S2, D=D,
        starts=pg.starts, row=row, col=col, w0=w0, gid=gid,
        is_local=is_local, is_ghost=is_ghost, is_iface=is_iface,
        deg_local=deg_local, owner_pe=owner_pe, iface_slots=iface_slots,
        ghost_owner_slot=ghost_owner_slot, window=window,
        win_complete=win_complete, win_adj_bits=win_adj_bits,
        edge_common=edge_common, Dc=Dc,
        send_slot=send_slot, recv_ghost=recv_ghost,
    )


def gather_global_members(
    pg: PartitionedGraph, status: np.ndarray
) -> np.ndarray:
    """Assemble the global member mask from per-PE INCLUDED statuses."""
    members = np.zeros(pg.n_global, dtype=bool)
    for i in range(pg.p):
        loc = pg.is_local[i]
        inc = loc & (status[i] == INCLUDED)
        members[pg.gid[i][inc]] = True
    return members
