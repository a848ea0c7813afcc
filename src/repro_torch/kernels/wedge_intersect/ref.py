"""Plain torch versions of the per-edge window intersection.

Copies of ``repro/kernels/wedge_intersect/ref.py`` over torch tensors:
:func:`wedge_intersect_ref` takes the gathered ``[E, D]`` operands of the
TPU kernel, :func:`common_neighbor_stats_ref` the ``[V, D]`` windows and the
edge list.  The latter is the plain version of the hand-written CUDA kernel
in :mod:`repro_torch.kernels.wedge_intersect.kernel`: the CPU path, and
what the kernel is held against on the card.  Both materialise the
``[E, D, D]`` compare.  int32 results; the sums wrap like int32.
"""

from __future__ import annotations

import torch


def wedge_intersect_ref(wu, wv, awu, actu):
    """(C, K) from W(u), W(v), the active-masked weights of W(u) and its
    activity, all [E, D] int32."""
    match = (wu[:, :, None] == wv[:, None, :]).any(-1) & (actu == 1)
    c = (awu * match).sum(-1).to(torch.int32)
    k = match.sum(-1).to(torch.int32)
    return c, k


def common_neighbor_stats_ref(window, weights, active, row, col):
    """(C[e], K[e]) over the windows themselves: entries are drawn from
    W(row), membership is tested against W(col), weights are masked by the
    match directly.  Window entries are taken to be valid vertex indices."""
    wu = window[row.long()].long()
    wv = window[col.long()]
    match = (wu[:, :, None] == wv[:, None, :]).any(-1) & active[wu]
    c = torch.where(match, weights[wu], 0).sum(-1).to(torch.int32)
    k = match.sum(-1).to(torch.int32)
    return c, k
