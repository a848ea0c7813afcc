"""Instance validation, canonicalization, and verified outputs.

A copy of :mod:`repro.core.validate` (plain numpy) over the port's
:mod:`repro_torch.core.graph`; the port imports nothing of the reference.

The serving layer admits instances from untrusted callers, and the paper's
central robustness claim — reductions are *equivalence-preserving*
(α-preservation, §reconstruction) — is only meaningful on a well-formed
input: a symmetric, loop-free CSR graph with non-negative integer weights
(:class:`repro_torch.core.graph.Graph`'s documented contract).  This module is
the admission gate and the post-solve auditor:

  * :func:`canonicalize` — repair what is harmlessly repairable
    (self-loops dropped, duplicate directed edges deduped, asymmetric edge
    lists symmetrized, unsorted rows resorted, integral float weights cast)
    and **reject with a stable reason code** what is not (broken CSR
    structure, out-of-range indices, NaN/±inf weights, negative weights,
    int32 overflow).  Repairs never change the MWIS: a self-loop vertex is
    conventionally never a member, and dedup/symmetrize/sort preserve the
    undirected edge *set*.
  * :func:`verify_result` — the cheap O(n + m) post-solve checker: the
    returned mask is an independent set of the (canonical) instance and
    the reported weight matches a recomputation.  Wired into
    ``MWISService`` behind ``ServeConfig.verify`` (off | sample | full).

Reason codes are part of the service API (``ServeResult.reason``); keep
them stable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph

I32_MAX = np.iinfo(np.int32).max

# --------------------------------------------------------------------- #
# stable reject/error reason codes (the service API surface)
# --------------------------------------------------------------------- #
REASON_BAD_CSR = "bad_csr"            # indptr/indices structurally broken
REASON_BAD_INDEX = "bad_index"        # edge endpoint out of [0, n)
REASON_BAD_WEIGHT = "bad_weight"      # NaN/inf/non-integral/negative/overflow
REASON_OVERSIZE = "oversize"          # exceeds every serve cell (route to
                                      # repro_torch.core.solvers.solve)
REASON_PACK_FAILED = "pack_failed"    # partition/plan build raised
REASON_BACKEND_FAILED = "backend_failed"  # every backend in the chain raised
REASON_VERIFY_FAILED = "verify_failed"    # post-solve check rejected output

#: Repair tags canonicalize may report (informational, not errors).
REPAIR_SELF_LOOPS = "dropped_self_loops"
REPAIR_DUP_EDGES = "deduped_edges"
REPAIR_SYMMETRIZED = "symmetrized"
REPAIR_RESORTED = "resorted_rows"
REPAIR_WEIGHT_CAST = "cast_weights"


class InvalidInstance(ValueError):
    """Rejected instance; ``reason`` is a stable code, ``detail`` human text."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


class ValidationReport(NamedTuple):
    ok: bool
    reason: Optional[str]        # reject reason code (None when ok)
    detail: str                  # human-readable explanation
    repairs: Tuple[str, ...]     # canonicalizations applied (ok case)


def _reject(reason: str, detail: str) -> Tuple[None, ValidationReport]:
    return None, ValidationReport(False, reason, detail, ())


def residual_weights(w, *, where: str = "residual") -> np.ndarray:
    """Folded weight plane of a mid-solve residual, checked into int32.

    Reduction folds rewrite weights (w(u) -= w(v), weight transfers), so a
    residual extracted mid-solve carries *derived* weights that no input
    gate ever saw.  The old ``solve_compact`` path gathered them as int64
    and silently ``.astype(np.int32)``-downcast — an overflow there wraps
    negative and corrupts every later beat test.  This is the checked seam:
    any value outside [0, I32_MAX] raises :class:`InvalidInstance` with the
    stable ``bad_weight`` reason instead of wrapping.
    """
    w64 = np.asarray(w).astype(np.int64, copy=False)
    if w64.size:
        lo, hi = int(w64.min()), int(w64.max())
        if lo < 0 or hi > I32_MAX:
            raise InvalidInstance(
                REASON_BAD_WEIGHT,
                f"{where}: folded weights out of int32 range "
                f"(min={lo}, max={hi})")
    return w64.astype(np.int32)


def canonicalize(g: Graph) -> Tuple[Optional[Graph], ValidationReport]:
    """Validate + canonicalize one instance; never raises.

    Returns ``(graph, report)``: on success the graph is the input object
    itself when it was already canonical (identity preserved so topology
    caches keep hitting) or a repaired copy; on rejection the graph is
    ``None`` and ``report.reason`` carries the stable code.
    """
    # -- structure: the three arrays must exist and be 1-D numerics ----- #
    try:
        indptr = np.asarray(g.indptr)
        indices = np.asarray(g.indices)
        weights = np.asarray(g.weights)
    except Exception as e:  # noqa: BLE001 — malformed duck-typed input
        return _reject(REASON_BAD_CSR, f"not array-like: {e}")
    if indptr.ndim != 1 or indices.ndim != 1 or weights.ndim != 1:
        return _reject(REASON_BAD_CSR, "indptr/indices/weights must be 1-D")
    if not np.issubdtype(indptr.dtype, np.integer):
        return _reject(REASON_BAD_CSR, f"indptr dtype {indptr.dtype} not integer")
    n = int(weights.shape[0])

    # -- weights: finite, integral, in [0, int32 max] ------------------- #
    repairs = []
    if np.issubdtype(weights.dtype, np.floating):
        if not np.all(np.isfinite(weights)):
            return _reject(REASON_BAD_WEIGHT, "non-finite (NaN/inf) weights")
        if np.any(weights != np.trunc(weights)):
            return _reject(REASON_BAD_WEIGHT, "non-integral float weights")
        repairs.append(REPAIR_WEIGHT_CAST)
    elif not np.issubdtype(weights.dtype, np.integer):
        return _reject(REASON_BAD_WEIGHT,
                       f"weight dtype {weights.dtype} is not numeric-integral")
    w64 = weights.astype(np.int64, copy=False)
    if n and int(w64.min()) < 0:
        return _reject(REASON_BAD_WEIGHT, "negative weights")
    if n and int(w64.max()) > I32_MAX:
        return _reject(REASON_BAD_WEIGHT, "weights overflow int32")
    if weights.dtype != np.int32:
        if REPAIR_WEIGHT_CAST not in repairs:
            repairs.append(REPAIR_WEIGHT_CAST)
    w32 = w64.astype(np.int32)

    # -- CSR invariants ------------------------------------------------- #
    if indptr.shape[0] != n + 1:
        return _reject(
            REASON_BAD_CSR,
            f"indptr has {indptr.shape[0]} entries for n={n} (want n+1)")
    if indptr.size and (int(indptr[0]) != 0
                        or int(indptr[-1]) != indices.shape[0]):
        return _reject(REASON_BAD_CSR,
                       "indptr[0] != 0 or indptr[-1] != len(indices)")
    if np.any(np.diff(indptr) < 0):
        return _reject(REASON_BAD_CSR, "indptr not monotone")
    if indices.size:
        if not np.issubdtype(indices.dtype, np.integer):
            return _reject(REASON_BAD_INDEX,
                           f"indices dtype {indices.dtype} not integer")
        if int(indices.min()) < 0 or int(indices.max()) >= n:
            return _reject(REASON_BAD_INDEX,
                           f"edge endpoint out of range [0, {n})")

    # -- edge canonicalization: loops, dups, asymmetry, order ----------- #
    src = np.repeat(np.arange(n, dtype=np.int64),
                    np.diff(indptr).astype(np.int64))
    dst = indices.astype(np.int64)
    loops = src == dst
    if np.any(loops):
        repairs.append(REPAIR_SELF_LOOPS)
        src, dst = src[~loops], dst[~loops]
    # undirected edge set: unique (min, max) pairs, re-emitted both ways
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    und = np.unique(np.stack([lo, hi], axis=1), axis=0) if src.size else \
        np.zeros((0, 2), np.int64)
    canon_src = np.concatenate([und[:, 0], und[:, 1]])
    canon_dst = np.concatenate([und[:, 1], und[:, 0]])
    order = np.lexsort((canon_dst, canon_src))
    canon_src, canon_dst = canon_src[order], canon_dst[order]
    dir_pairs = (np.unique(np.stack([src, dst], axis=1), axis=0)
                 if src.size else np.zeros((0, 2), np.int64))
    if dir_pairs.shape[0] != src.shape[0]:
        repairs.append(REPAIR_DUP_EDGES)
    if dir_pairs.shape[0] != canon_src.shape[0]:
        repairs.append(REPAIR_SYMMETRIZED)
    if (REPAIR_DUP_EDGES not in repairs
            and REPAIR_SYMMETRIZED not in repairs
            and not (np.array_equal(canon_src, src)
                     and np.array_equal(canon_dst, dst))):
        repairs.append(REPAIR_RESORTED)

    if not repairs:
        return g, ValidationReport(True, None, "canonical", ())

    counts = np.bincount(canon_src, minlength=n).astype(np.int64)
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_indptr[1:])
    fixed = Graph(indptr=new_indptr, indices=canon_dst.astype(np.int32),
                  weights=w32)
    return fixed, ValidationReport(True, None, "repaired", tuple(repairs))


def validate_instance(g: Graph) -> Graph:
    """:func:`canonicalize` that raises :class:`InvalidInstance` on reject."""
    fixed, report = canonicalize(g)
    if not report.ok:
        raise InvalidInstance(report.reason, report.detail)
    return fixed


# --------------------------------------------------------------------- #
# post-solve output verification
# --------------------------------------------------------------------- #
class VerifyReport(NamedTuple):
    ok: bool
    reason: Optional[str]    # REASON_VERIFY_FAILED when not ok
    detail: str
    weight: int              # recomputed solution weight


def verify_result(
    g: Graph, members: np.ndarray, weight: Optional[int] = None
) -> VerifyReport:
    """Cheap O(n + m) audit of a solver output against its instance.

    Checks that ``members`` is a [n] boolean mask, that it is an
    independent set of ``g`` (no edge with both endpoints selected), and —
    when ``weight`` is given — that the reported weight equals the
    recomputed ``Σ w[members]``.  Never raises; the report is structured
    so the service can degrade per-request.
    """
    m = np.asarray(members)
    if m.shape != (g.n,) or m.dtype != np.bool_:
        return VerifyReport(
            False, REASON_VERIFY_FAILED,
            f"mask shape/dtype {m.shape}/{m.dtype} != ({g.n},)/bool", 0)
    src = g.edge_sources()
    conflicts = int(np.count_nonzero(m[src] & m[g.indices]))
    got = int(g.weights[m].sum(dtype=np.int64))
    if conflicts:
        return VerifyReport(
            False, REASON_VERIFY_FAILED,
            f"{conflicts // 2} edge(s) with both endpoints selected", got)
    if weight is not None and got != int(weight):
        return VerifyReport(
            False, REASON_VERIFY_FAILED,
            f"reported weight {int(weight)} != recomputed {got}", got)
    return VerifyReport(True, None, "verified", got)
