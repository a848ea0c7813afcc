"""ctypes wrapper of the sum-mode EmbeddingBag CUDA kernel.

``embedding_bag`` is the Hopper counterpart of
``repro/kernels/embedding_bag/kernel.py:embedding_bag_fused``
(``csrc/embedding_bag.cu`` says how it is laid out and what bounds it).
CUDA tensors only: a float32 or bfloat16 table, int32 indices, float32
weights.  Anything else raises, there is no fallback.  The plain version is
:func:`repro_torch.kernels.embedding_bag.ref.embedding_bag_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import check, launch, load, require_cuda

_CSRC = Path(__file__).resolve().parent / "csrc"
#: The kernel's (library name, sources), for ``kernels.build_many``.
LIBS = {"embedding_bag": ("embedding_bag", (_CSRC / "embedding_bag.cu",))}

#: Table types and their code in the C interface.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load(*LIBS["embedding_bag"]).embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def embedding_bag(
    table: torch.Tensor,   # [V, D] float32 / bfloat16
    idx: torch.Tensor,     # [B, K] i32 rows of the table
    wgt: torch.Tensor,     # [B, K] f32 per-sample weights
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns [B, D] in the
    table's type (float32 accumulation).  An index reads the row the
    reference's ``table[idx]`` reads: a negative one wraps once, then it is
    clamped into [0, V - 1] (``ref.table_rows``).  Does not synchronise."""
    device = table.device
    check("table", table, device, 2, tuple(_DTYPES))
    check("idx", idx, device, 2)
    check("wgt", wgt, device, 2, (torch.float32,))
    if wgt.shape != idx.shape:
        raise ValueError(f"wgt {tuple(wgt.shape)} != idx {tuple(idx.shape)}")
    require_cuda("embedding_bag", device)
    n_bags, k_bag = idx.shape
    d = table.shape[1]
    out = torch.empty((n_bags, d), dtype=table.dtype, device=device)
    if n_bags == 0 or d == 0:
        return out
    if k_bag == 0:
        return out.zero_()
    vec16 = (d * table.element_size()) % 16 == 0 and table.data_ptr() % 16 == 0
    launch("embedding_bag", _launcher(), device,
           table.data_ptr(), idx.data_ptr(), wgt.data_ptr(), out.data_ptr(),
           n_bags, k_bag, d, table.shape[0], _DTYPES[table.dtype],
           int(vec16))
    return out
