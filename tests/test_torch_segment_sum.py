"""Port parity: the float blocked segment sum's plain torch version against
the JAX Pallas kernel (interpret mode), its ops wrapper and
``jax.ops.segment_sum`` over the unpacked rows.

Tolerances.  float32: 1e-6 (rtol and atol), as the JAX package's own test.
bfloat16: the port, like the TPU kernel, sums in float32 and rounds once;
two such sums in different orders may round to neighbouring bfloat16
values, so the port is held to one bfloat16 ulp (rtol and atol 2^-7) of
the Pallas kernel and of a float32 sum of the unpacked rows.  Against
``jax.ops.segment_sum`` and the JAX blocked oracle, which round after every
add, it is held to the JAX test's 6e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_coo import ops as jops
from repro.kernels.segment_coo.kernel import segment_sum_blocked
from repro.kernels.segment_coo.ref import segment_sum_blocked_ref as jref
from repro_torch import kernels
from repro_torch.kernels.segment_coo import kernel as tkernel
from repro_torch.kernels.segment_coo import ops as tops
from repro_torch.kernels.segment_coo.ref import (
    segment_sum_blocked_ref, segment_sum_ref,
)

from _torch_jax import _release_jax_programs  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the shapes of tests/test_kernels.py::test_segment_coo_kernel_matches_ref
SHAPES = [(17, 120, 8, 8), (64, 9, 128, 8), (5, 64, 16, 4), (33, 257, 32, 16)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
#: (rtol = atol) against a float32-accumulated sum, and against one that
#: rounds after every add
TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2.0 ** -7, 6e-2)}


def _case(n_rows, n_edges, d, r_blk, jdt):
    """Row ids, the payload as a JAX array and as the same values in torch,
    and the packing."""
    rng = np.random.default_rng(0)
    row = rng.integers(0, n_rows, size=n_edges).astype(np.int32)
    jdata = jnp.asarray(rng.normal(size=(n_edges, d)), jdt)
    # one rounding to the type, on the JAX side; float32 holds it exactly
    tdata = torch.from_numpy(np.array(jdata, np.float32))
    perm, lrow, e_blk = jops.pack_blocks(row, n_rows, r_blk=r_blk)
    return row, jdata, tdata, perm, lrow, e_blk


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n_rows,n_edges,d,r_blk", SHAPES)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_blocked_ref_matches_pallas_kernel(n_rows, n_edges, d, r_blk, jdt,
                                          tdt):
    _, jdata, tdata, perm, lrow, e_blk = _case(n_rows, n_edges, d, r_blk, jdt)
    jblk = jdata[jnp.asarray(perm.reshape(-1))].reshape(-1, e_blk, d)
    tblk = tdata.to(tdt)[torch.from_numpy(perm.reshape(-1))].reshape(
        -1, e_blk, d)
    got = segment_sum_blocked_ref(tblk, torch.from_numpy(lrow), r_blk=r_blk)
    assert got.dtype == tdt and got.shape == (perm.shape[0], r_blk, d)
    want = segment_sum_blocked(jblk, jnp.asarray(lrow), r_blk=r_blk,
                               interpret=True)
    _close(got.float(), want, TOL[tdt][0])
    # the JAX oracle rounds after every add in bfloat16
    want = jref(jblk, jnp.asarray(lrow), r_blk=r_blk)
    _close(got.float(), want, TOL[tdt][1])


@pytest.mark.parametrize("n_rows,n_edges,d,r_blk", SHAPES)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_segment_sum_coo_matches_pallas_wrapper(n_rows, n_edges, d, r_blk,
                                               jdt, tdt):
    """The port's op on CPU tensors (its plain version) == the JAX wrapper
    forced through the Pallas kernel, == a float32 segment sum of the
    unpacked rows, and == ``jax.ops.segment_sum``; no kernel launch."""
    row, jdata, tdata, perm, lrow, _ = _case(n_rows, n_edges, d, r_blk, jdt)
    before = kernels.launch_count("segment_sum")
    got = tops.segment_sum_coo(
        tdata.to(tdt), torch.from_numpy(perm.astype(np.int32)),
        torch.from_numpy(lrow), n_rows, r_blk=r_blk)
    assert kernels.launch_count("segment_sum") == before
    assert got.dtype == tdt and got.shape == (n_rows, d)
    want = jops.segment_sum_coo(jdata, jnp.asarray(perm), jnp.asarray(lrow),
                                n_rows, r_blk=r_blk, force_pallas=True)
    _close(got.float(), want, TOL[tdt][0])
    unpacked = segment_sum_ref(tdata.to(tdt), torch.from_numpy(row), n_rows)
    _close(got.float(), unpacked.float(), TOL[tdt][0])
    want = jax.ops.segment_sum(jdata, jnp.asarray(row), num_segments=n_rows)
    _close(got.float(), want, TOL[tdt][1])


def test_segment_sum_ref_rounds_once():
    """bfloat16 payloads accumulate in float32: 300 ones sum to 300, where
    a bfloat16 running sum stalls at 256 (256 + 1 rounds back to 256)."""
    got = segment_sum_ref(torch.ones((300, 1), dtype=torch.bfloat16),
                          torch.zeros(300, dtype=torch.int64), 1)
    assert got.dtype == torch.bfloat16
    assert float(got) == 300.0


def test_segment_sum_wrapper_refuses_what_it_cannot_run():
    """The kernel wrapper checks before it builds or launches anything: a
    wrong payload type, mixed devices, an r_blk whose accumulators do not
    fit a block's shared memory and CPU tensors raise, and nothing is
    counted as a launch; the op raises on a mix of devices."""
    row = np.array([0, 1, 1, 3], np.int32)
    perm, lrow, _ = tops.pack_blocks(row, 4, r_blk=8)
    perm = torch.from_numpy(perm.astype(np.int32))
    lrow = torch.from_numpy(lrow)
    data = torch.ones((4, 3))
    before = kernels.launch_count("segment_sum")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tkernel.segment_sum(data.double(), perm, lrow, 4, r_blk=8)
    with pytest.raises(ValueError, match="is on meta"):
        tkernel.segment_sum(data.to("meta"), perm, lrow, 4, r_blk=8)
    with pytest.raises(ValueError, match="shared memory"):
        tkernel.segment_sum(data, perm, lrow, 4, r_blk=453)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.segment_sum(data, perm, lrow, 4, r_blk=8)
    with pytest.raises(ValueError, match="expected all on the CPU"):
        tops.segment_sum_coo(data.to("meta"), perm, lrow, 4, r_blk=8)
    assert kernels.launch_count("segment_sum") == before


@pytest.mark.parametrize("d,dtype,offset,vec", [
    (602, torch.float32, 0, 2), (602, torch.bfloat16, 0, 2),
    (128, torch.float32, 0, 4), (128, torch.bfloat16, 0, 4),
    (130, torch.float32, 0, 2), (64, torch.float32, 0, 2),
    (3, torch.float32, 0, 1), (1, torch.bfloat16, 0, 1),
    (128, torch.float32, 1, 1), (256, torch.bfloat16, 1, 1),
    (256, torch.bfloat16, 2, 2),
])
def test_segment_sum_lane_width(d, dtype, offset, vec):
    """The columns a kernel lane reads at once: the widest of 4, 2, 1 that
    divides the row, that the payload pointer (here a view ``offset``
    elements into a fresh buffer) is aligned to, and that leaves no lane of
    a 32-lane warp past a narrow row."""
    buf = torch.zeros(4 * d + offset, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    data = buf[offset:offset + 4 * d].view(4, d)
    assert tkernel._sum_vec(data) == vec
