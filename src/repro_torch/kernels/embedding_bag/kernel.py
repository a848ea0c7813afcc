"""ctypes wrappers of the sum-mode EmbeddingBag CUDA kernels.

``embedding_bag`` is the Hopper counterpart of
``repro/kernels/embedding_bag/kernel.py:embedding_bag_fused``;
``embedding_bag_bwd``, the table's gradient, is the port's own (the
reference differentiates ``jnp.take``).  ``csrc/embedding_bag.cu`` says
how each is laid out and what bounds it.  CUDA tensors only: a float32 or
bfloat16 table (or cotangent), int32 indices, float32 weights.  Anything
else raises, there is no fallback.  The plain versions are
:func:`repro_torch.kernels.embedding_bag.ref.embedding_bag_ref` and
:func:`~repro_torch.kernels.embedding_bag.ref.embedding_bag_bwd_ref`.
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
def _launcher(entry: str = "embedding_bag_launch"):
    fn = getattr(load(*LIBS["embedding_bag"]), entry)
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


def embedding_bag_bwd(
    grad_out: torch.Tensor,   # [B, D] float32 / bfloat16 cotangent
    idx: torch.Tensor,        # [B, K] i32 rows of the table
    wgt: torch.Tensor,        # [B, K] f32 per-sample weights
    n_rows: int,
    *,
    out: torch.Tensor | None = None,   # [n_rows, D] f32 buffer to add into
) -> torch.Tensor:
    """Launch the backward on the current stream: add each live lookup's
    ``wgt[b, k] * grad_out[b]`` into its row of a float32 [n_rows, D]
    buffer (a fresh zeroed one unless ``out`` is given) and return it.  A
    negative index wraps once; one still outside [0, n_rows) is dropped
    (``ref.live_rows``).  Does not synchronise."""
    device = grad_out.device
    check("grad_out", grad_out, device, 2, tuple(_DTYPES))
    check("idx", idx, device, 2)
    check("wgt", wgt, device, 2, (torch.float32,))
    if wgt.shape != idx.shape or idx.shape[0] != grad_out.shape[0]:
        raise ValueError(f"grad_out {tuple(grad_out.shape)}, idx "
                         f"{tuple(idx.shape)} and wgt {tuple(wgt.shape)} "
                         f"disagree")
    n_bags, k_bag = idx.shape
    d = grad_out.shape[1]
    if out is not None:
        check("out", out, device, 2, (torch.float32,))
        if out.shape != (n_rows, d):
            raise ValueError(f"out {tuple(out.shape)} != ({n_rows}, {d})")
    require_cuda("embedding_bag_backward", device)
    if out is None:
        out = torch.zeros((n_rows, d), dtype=torch.float32, device=device)
    if n_bags == 0 or k_bag == 0 or d == 0:
        return out
    vec4 = (d % 4 == 0 and grad_out.data_ptr() % (4 * grad_out.element_size())
            == 0 and out.data_ptr() % 16 == 0)
    launch("embedding_bag_backward", _launcher("embedding_bag_bwd_launch"),
           device, grad_out.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
           out.data_ptr(), n_bags, k_bag, d, n_rows,
           _DTYPES[grad_out.dtype], int(vec4))
    return out
