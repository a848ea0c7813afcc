"""ctypes wrapper of the per-edge window-intersection CUDA kernel.

``wedge_intersect`` is the Hopper counterpart of
``repro/kernels/wedge_intersect/kernel.py:wedge_intersect``
(``csrc/wedge_intersect.cu`` says how it is laid out and what bounds it;
``tools/wedge_intersect_variants.py`` times it against the designs it was
chosen over).
It takes what ``common_neighbor_stats`` takes — the ``[V, D]`` windows, the
vertex weights and activity and the edge list — and gathers W(u), W(v), the
weights and the activity inside the kernel.  CUDA tensors only (int32, the
activity bool or uint8), window width 1..32: anything else raises, there is
no fallback.  The plain version is
:func:`repro_torch.kernels.wedge_intersect.ref.common_neighbor_stats_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import check, launch, load, require_cuda

_CSRC = Path(__file__).resolve().parent / "csrc"
#: The kernel's (library name, sources), for ``kernels.build_many``.
LIBS = {"wedge_intersect": ("wedge_intersect",
                            (_CSRC / "wedge_intersect.cu",))}

#: Widest window the kernel takes (its registers hold two rows).
MAX_D = 32

#: The C launcher's argument types (pointers: window, weights, active, row,
#: col, C, K; then E, D, vec16 and the stream).
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load(*LIBS["wedge_intersect"]).wedge_intersect_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def wedge_intersect(
    window: torch.Tensor,    # [V, D] i32 capped neighbor lists (nil padded)
    weights: torch.Tensor,   # [V] i32 current weights
    active: torch.Tensor,    # [V] bool / uint8 (1 = active)
    row: torch.Tensor,       # [E] i32 edge sources
    col: torch.Tensor,       # [E] i32 edge targets
):
    """Launch the kernel on the current stream; returns (C, K), two [E]
    int32 tensors.  Every index (row, col, window entries) must be a valid
    vertex: the kernel does not check them (JAX's gathers clamp, torch's
    raise).  Does not synchronise."""
    device = window.device
    check("window", window, device, 2)
    check("weights", weights, device, 1)
    check("active", active, device, 1, (torch.bool, torch.uint8))
    check("row", row, device, 1)
    check("col", col, device, 1)
    n_vertices, d = window.shape
    if not 0 < d <= MAX_D:
        raise ValueError(f"window width {d} outside 1..{MAX_D}")
    if weights.shape[0] != n_vertices or active.shape[0] != n_vertices:
        raise ValueError(f"weights {tuple(weights.shape)} / active "
                         f"{tuple(active.shape)} do not match the window's "
                         f"{n_vertices} vertices")
    if row.shape != col.shape:
        raise ValueError(f"row {tuple(row.shape)} != col {tuple(col.shape)}")
    require_cuda("wedge_intersect", device)
    n_edges = row.shape[0]
    out_c = torch.empty(n_edges, dtype=torch.int32, device=device)
    out_k = torch.empty(n_edges, dtype=torch.int32, device=device)
    if n_edges == 0:
        return out_c, out_k
    # rows are read as 16-byte vectors only where every row starts on a
    # 16-byte boundary (a view may start at any element)
    vec16 = d % 4 == 0 and window.data_ptr() % 16 == 0
    launch("wedge_intersect", _launcher(), device,
           window.data_ptr(), weights.data_ptr(), active.data_ptr(),
           row.data_ptr(), col.data_ptr(), out_c.data_ptr(),
           out_k.data_ptr(), n_edges, d, int(vec16))
    return out_c, out_k
