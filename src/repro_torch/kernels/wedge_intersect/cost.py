"""The work of the window-intersection kernel as a formula of its
arguments: what ``chip_smoke.py`` bounds a call by and what a work counter
(``repro_torch.analysis.count``) records a call as."""

from __future__ import annotations

import torch

from repro_torch.kernels import Work


def wedge_intersect_work(window: torch.Tensor, weights: torch.Tensor,
                         active: torch.Tensor, row: torch.Tensor,
                         col: torch.Tensor) -> Work:
    """Least bytes: row, col and both int32 outputs an edge; the window,
    weight and activity of every vertex.  Least operations: the windows
    are sorted with the nil padding last (``core/partition.py``), so a
    merge of W(row) and W(col) takes one int32 compare per distinct entry
    of the two (the padding's nil counts once), not the D × D of the TPU
    kernel."""
    n_edges = row.shape[0]
    n_vertices, d = window.shape
    distinct = 1 + (window[:, 1:] != window[:, :-1]).sum(1)
    return Work(int(distinct[row.long()].sum() + distinct[col.long()].sum()),
                "int32", 16 * n_edges + n_vertices * (4 * d + 5))
