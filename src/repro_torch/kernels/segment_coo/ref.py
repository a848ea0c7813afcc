"""Plain torch versions of the segment reductions.

These mirror ``jax.ops.segment_{sum,max,min}`` exactly: the output has
``num_segments`` rows, empty segments hold the reduction identity (0, the
dtype's min for max, its max for min), and integer sums wrap like int32.
``segment_fused_blocked_ref`` and ``segment_sum_blocked_ref`` are the plain
versions of the hand-written CUDA kernels in
:mod:`repro_torch.kernels.segment_coo.kernel`: the CPU path, and what the
kernels are held against on the card.
"""

from __future__ import annotations

import torch


def _identity(dtype: torch.dtype, kind: str):
    """Empty-segment fill of jax.ops.segment_max / segment_min."""
    if dtype.is_floating_point:
        return {"max": float("-inf"), "min": float("inf")}[kind]
    info = torch.iinfo(dtype)
    return {"max": info.min, "min": info.max}[kind]


def _expand(seg: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return seg.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, seg, data)


def segment_sum_ref(data: torch.Tensor, seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Plain COO segment sum as the float kernels compute it: bfloat16 /
    float16 payloads accumulate in float32 and round to their type once."""
    acc = (torch.promote_types(data.dtype, torch.float32)
           if data.dtype.is_floating_point else data.dtype)
    return segment_sum(data.to(acc), seg, num_segments).to(data.dtype)


def segment_max(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.full((num_segments,) + data.shape[1:],
                     _identity(data.dtype, "max"), dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, _expand(seg, data), data, "amax",
                               include_self=True)


def segment_min(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.full((num_segments,) + data.shape[1:],
                     _identity(data.dtype, "min"), dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, _expand(seg, data), data, "amin",
                               include_self=True)


def segment_or_ref(
    data: torch.Tensor,   # [E, Do] ints; only bits < nbits are reduced
    seg: torch.Tensor,    # [E] segment ids
    num_segments: int,
    *,
    nbits: int,
) -> torch.Tensor:
    """Per-segment bitwise OR (torch has no OR scatter reduce): split into
    ``nbits`` 0/1 bitplanes, segment-sum them, repack with count > 0.
    Exact for any edge order (counting is associative)."""
    E, Do = data.shape
    shifts = torch.arange(nbits, dtype=data.dtype, device=data.device)
    planes = ((data[:, :, None] >> shifts) & 1).reshape(E, Do * nbits)
    cnt = segment_sum(planes, seg, num_segments).reshape(
        num_segments, Do, nbits
    )
    return ((cnt > 0).to(data.dtype) << shifts).sum(dim=-1, dtype=data.dtype)


def _block_segments(lrow: torch.Tensor, r_blk: int):
    """Flat segment ids of a [n_blocks, E_BLK] packing: block b's local row
    r is segment b*(r_blk+1) + r, and segment b*(r_blk+1) + r_blk collects
    the padding slots (out-of-range local rows are padding too, as jax.ops
    drops them).  Returns (seg [n_blocks*E_BLK] i64, n_seg)."""
    n_blocks = lrow.shape[0]
    lr = torch.where((lrow < 0) | (lrow > r_blk), r_blk, lrow)
    seg = (
        torch.arange(n_blocks, device=lrow.device, dtype=torch.int64)[:, None]
        * (r_blk + 1) + lr.to(torch.int64)
    ).reshape(-1)
    return seg, n_blocks * (r_blk + 1)


def live_extent(lrow: torch.Tensor, r_blk: int) -> torch.Tensor:
    """One past the last live slot of each row block of a blocked plan:
    ``[(B,) n_blocks, E_BLK]`` local rows → ``[(B,) n_blocks]`` int32 (0 for
    a block with no live slot; a slot is live where 0 <= lrow < r_blk).
    Every slot from it on is padding, so a kernel may stop there."""
    live = (lrow >= 0) & (lrow < r_blk)
    pos = torch.arange(1, lrow.shape[-1] + 1, dtype=torch.int32,
                       device=lrow.device)
    return torch.where(live, pos, 0).amax(-1).to(torch.int32)


def segment_sum_blocked_ref(
    data: torch.Tensor,   # [n_blocks, E_BLK, D] gathered float payloads
    lrow: torch.Tensor,   # [n_blocks, E_BLK] (R_BLK = padding)
    *,
    r_blk: int,
) -> torch.Tensor:
    """Per-block segment sum; returns [n_blocks, R_BLK, D] in data's type.
    Accumulates in float32 and rounds once, as the TPU kernel's one-hot
    matmul does (``preferred_element_type=f32``)."""
    n_blocks, e_blk, d = data.shape
    seg, n_seg = _block_segments(lrow, r_blk)
    out = segment_sum_ref(data.reshape(n_blocks * e_blk, d), seg, n_seg)
    return out.reshape(n_blocks, r_blk + 1, d)[:, :r_blk]


def segment_fused_blocked_ref(
    data_sum: torch.Tensor | None,   # [(B,) n_blocks, E_BLK, Ds]
    data_max: torch.Tensor | None,   # [(B,) n_blocks, E_BLK, Dm]
    data_min: torch.Tensor | None,   # [(B,) n_blocks, E_BLK, Dn]
    lrow: torch.Tensor,              # [(B,) n_blocks, E_BLK] (R_BLK = pad)
    *,
    r_blk: int,
    data_or: torch.Tensor | None = None,   # [(B,) n_blocks, E_BLK, Do]
    or_nbits: int = 16,
):
    """Per-block sum/max/min/or reductions of gathered edge payloads;
    returns a (sum, max, min, or) tuple of [(B,) n_blocks, R_BLK, D*]
    tensors (None for absent groups).  Row ``r_blk`` of every block
    collects the padding slots and is sliced off.  A leading batch axis
    (stacked plans) is a run of independent blocks: the batched plain
    version of the kernel's second grid axis."""
    lead, e_blk = lrow.shape[:-1], lrow.shape[-1]
    n_blocks = lead.numel()
    seg, n_seg = _block_segments(lrow.reshape(n_blocks, e_blk), r_blk)

    def blocked(op, data, **kw):
        if data is None:
            return None
        flat = data.reshape(n_blocks * e_blk, data.shape[-1])
        out = op(flat, seg, n_seg, **kw)
        return out.reshape(*lead, r_blk + 1, -1)[..., :r_blk, :]

    return (
        blocked(segment_sum, data_sum),
        blocked(segment_max, data_max),
        blocked(segment_min, data_min),
        blocked(segment_or_ref, data_or, nbits=or_nbits),
    )
