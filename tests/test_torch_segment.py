"""Port parity: the fused segment reduction's plain torch version against the
JAX Pallas kernel (interpret mode) and its ops wrapper, bit for bit.

All payloads are int32, so the tolerance is exactly zero everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_coo import ops as jops
from repro.kernels.segment_coo.kernel import segment_fused_blocked
from repro_torch import kernels
from repro_torch.kernels.segment_coo import kernel as tkernel
from repro_torch.kernels.segment_coo import ops as tops
from repro_torch.kernels.segment_coo.ref import (
    segment_fused_blocked_ref, segment_max, segment_min, segment_or_ref,
    segment_sum,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, n_rows, n_edges, widths, lo=-500, hi=500, or_hi=1 << 20):
    """Row ids + int32 payload groups (None where the width is 0).  OR
    payloads deliberately carry bits above every or_nbits tested."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows, size=n_edges).astype(np.int32)
    groups = []
    for k, d in enumerate(widths):
        if not d:
            groups.append(None)
        elif k == 3:
            groups.append(rng.integers(-or_hi, or_hi, size=(n_edges, d))
                          .astype(np.int32))
        else:
            groups.append(rng.integers(lo, hi, size=(n_edges, d))
                          .astype(np.int32))
    return row, groups


def _blocked(a, perm):
    if a is None:
        return None
    return a[perm.reshape(-1)].reshape(perm.shape[0], perm.shape[1], -1)


def _assert_groups_equal(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# (n_rows, n_edges, r_blk, (Ds, Dm, Dn, Do), or_nbits); n_rows > n_edges
# leaves empty rows, so the identities are exercised.
CASES = [
    (17, 120, 8, (2, 2, 1, 0), 16),
    (64, 9, 8, (2, 2, 1, 0), 16),
    (33, 257, 16, (2, 2, 1, 0), 16),
    (23, 77, 8, (0, 3, 0, 0), 16),      # a single partial group
    (17, 120, 8, (1, 0, 0, 2), 12),     # OR with truncation
    (33, 257, 16, (0, 0, 0, 2), 16),
    (64, 9, 8, (0, 0, 0, 2), 5),
    (40, 300, 64, (2, 2, 0, 2), 8),     # the engine's shape: S/deg, M/only,
                                        # wbits/wnh at window cap 8
]


@pytest.mark.parametrize("n_rows,n_edges,r_blk,widths,nbits", CASES)
def test_blocked_ref_matches_pallas_kernel(n_rows, n_edges, r_blk, widths,
                                          nbits):
    row, groups = _case(3, n_rows, n_edges, widths)
    perm, lrow, _ = jops.pack_blocks(row, n_rows, r_blk=r_blk)
    blk = [_blocked(g, perm) for g in groups]
    want = segment_fused_blocked(
        *(None if b is None else jnp.asarray(b) for b in blk[:3]),
        jnp.asarray(lrow), r_blk=r_blk,
        data_or=None if blk[3] is None else jnp.asarray(blk[3]),
        or_nbits=nbits, interpret=True,
    )
    got = segment_fused_blocked_ref(
        *(None if b is None else torch.from_numpy(b) for b in blk[:3]),
        torch.from_numpy(lrow), r_blk=r_blk,
        data_or=None if blk[3] is None else torch.from_numpy(blk[3]),
        or_nbits=nbits,
    )
    _assert_groups_equal(got, want)


@pytest.mark.parametrize("n_rows,n_edges,r_blk,widths,nbits", CASES)
def test_segment_fused_coo_matches_pallas_wrapper(n_rows, n_edges, r_blk,
                                                 widths, nbits):
    """The port's dispatching op on CPU tensors (its plain version) == the
    JAX wrapper forced through the Pallas kernel, and == plain per-segment
    reductions over the unpacked COO list."""
    row, groups = _case(7, n_rows, n_edges, widths)
    perm, lrow, _ = jops.pack_blocks(row, n_rows, r_blk=r_blk)
    names = ("data_sum", "data_max", "data_min", "data_or")
    want = jops.segment_fused_coo(
        jnp.asarray(perm), jnp.asarray(lrow), n_rows,
        **{k: jnp.asarray(g) for k, g in zip(names, groups) if g is not None},
        or_nbits=nbits, r_blk=r_blk, force_pallas=True,
    )
    tperm = torch.from_numpy(perm.astype(np.int32))
    got = tops.segment_fused_coo(
        tperm, torch.from_numpy(lrow), n_rows,
        **{k: torch.from_numpy(g) for k, g in zip(names, groups)
           if g is not None},
        or_nbits=nbits, r_blk=r_blk,
    )
    _assert_groups_equal(got, want)
    seg = torch.from_numpy(row)
    ops = (segment_sum, segment_max, segment_min)
    for k in range(3):
        if groups[k] is not None:
            np.testing.assert_array_equal(
                got[k].numpy(),
                ops[k](torch.from_numpy(groups[k]), seg, n_rows).numpy(),
            )
    if groups[3] is not None:
        np.testing.assert_array_equal(
            got[3].numpy(),
            segment_or_ref(torch.from_numpy(groups[3]), seg, n_rows,
                           nbits=nbits).numpy(),
        )


@pytest.mark.parametrize("n_rows,n_edges,r_blk,mult", [
    (17, 120, 8, 1), (64, 9, 8, 8), (33, 257, 16, 8), (1000, 4000, 64, 8),
])
def test_pack_blocks_matches_reference(n_rows, n_edges, r_blk, mult):
    rng = np.random.default_rng(5)
    row = np.sort(rng.integers(0, n_rows, size=n_edges)).astype(np.int32)
    for want, got in zip(
        jops.pack_blocks(row, n_rows, r_blk=r_blk, e_blk_multiple=mult),
        tops.pack_blocks(row, n_rows, r_blk=r_blk, e_blk_multiple=mult),
    ):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_kernel_wrapper_refuses_what_it_cannot_run():
    """The CUDA wrapper validates before it builds or launches anything:
    a bad or_nbits, CPU tensors and mixed devices raise, and nothing is
    counted as a launch."""
    row, (dsum, _, _, _) = _case(1, 9, 20, (1, 0, 0, 0))
    perm, lrow, _ = tops.pack_blocks(row, 9, r_blk=8)
    perm = torch.from_numpy(perm.astype(np.int32))
    lrow = torch.from_numpy(lrow)
    before = kernels.launch_count("segment_fused")
    with pytest.raises(ValueError, match="or_nbits"):
        tkernel.segment_fused(perm, lrow, 9, r_blk=8,
                              data_sum=torch.from_numpy(dsum), or_nbits=32)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.segment_fused(perm, lrow, 9, r_blk=8,
                              data_sum=torch.from_numpy(dsum))
    with pytest.raises(ValueError, match="expected all on the CPU"):
        tops.segment_fused_coo(perm, lrow, 9, r_blk=8,
                               data_sum=torch.from_numpy(dsum).to("meta"))
    assert kernels.launch_count("segment_fused") == before
