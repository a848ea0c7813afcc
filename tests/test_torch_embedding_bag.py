"""Port parity: the sum-mode EmbeddingBag's plain torch version and ops
wrapper against the JAX package's oracle and its ops wrapper on the oracle
path.  The Pallas kernel itself is not run: it calls ``pl.load``, which the
installed jax no longer has.

Tolerances are the JAX test's (tests/test_kernels.py): float32 1e-5,
bfloat16 3e-2 (rtol and atol); both sides accumulate in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jref
from repro_torch import kernels
from repro_torch.kernels.embedding_bag import kernel as tkernel
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

from _torch_jax import _release_jax_programs  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = [(jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16,
                                               3e-2)]


# the shapes of tests/test_kernels.py::test_embedding_bag_kernel_matches_ref
@pytest.mark.parametrize("V,B,K,D", [
    (100, 33, 4, 16), (64, 8, 1, 128), (500, 70, 7, 32),
])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_embedding_bag_matches_reference(V, B, K, D, jdt, tdt, tol):
    _check_against_reference(V, B, K, D, jdt, tdt, tol)


# the widths and bag sizes of the kernel's two paths: rows of 8 to 128
# elements (narrow lane groups at 1-16 vectors, a warp a bag above), bags of
# 1 (single-hot, as dlrm looks up) to 7 lookups
@pytest.mark.parametrize("K", [1, 2, 3, 7])
@pytest.mark.parametrize("D", [8, 16, 64, 128])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_embedding_bag_widths_and_bag_sizes(K, D, jdt, tdt, tol):
    _check_against_reference(300, 37, K, D, jdt, tdt, tol)


def _check_against_reference(V, B, K, D, jdt, tdt, tol):
    rng = np.random.default_rng(2)
    jtable = jnp.asarray(rng.normal(size=(V, D)), jdt)
    idx = rng.integers(0, V, size=(B, K)).astype(np.int32)
    wgt = rng.normal(size=(B, K)).astype(np.float32)
    # the same table values on both sides (rounded once, by JAX)
    ttable = torch.from_numpy(np.array(jtable, np.float32)).to(tdt)
    targs = (ttable, torch.from_numpy(idx), torch.from_numpy(wgt))
    jargs = (jtable, jnp.asarray(idx), jnp.asarray(wgt))
    before = kernels.launch_count("embedding_bag")
    got = embedding_bag(*targs)
    assert kernels.launch_count("embedding_bag") == before
    assert got.dtype == tdt and got.shape == (B, D)
    for want in (jref(*jargs), jops.embedding_bag(*jargs, force_pallas=False)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    assert torch.equal(embedding_bag_ref(*targs), got)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_out_of_range_ids_read_the_reference_rows(jdt, tdt, tol):
    """The reference op's ``table[idx]`` wraps a negative id once, then
    clamps: ids V, V + 3, -1, -V and -V - 1 (among in-range ones, bags of
    1 and 3) read the rows the reference reads."""
    rng = np.random.default_rng(5)
    V, D = 40, 16
    jtable = jnp.asarray(rng.normal(size=(V, D)), jdt)
    odd = np.array([V, V + 3, -1, -V, -V - 1], np.int32)
    for K in (1, 3):
        idx = rng.integers(0, V, size=(5, K)).astype(np.int32)
        idx[:, 0] = odd
        wgt = rng.normal(size=(5, K)).astype(np.float32)
        got = embedding_bag(torch.from_numpy(np.array(jtable, np.float32))
                            .to(tdt), torch.from_numpy(idx),
                            torch.from_numpy(wgt))
        want = jops.embedding_bag(jtable, jnp.asarray(idx), jnp.asarray(wgt),
                                  force_pallas=False)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
        rows = np.where(idx < 0, idx + V, idx).clip(0, V - 1)
        assert torch.equal(got, embedding_bag(
            torch.from_numpy(np.array(jtable, np.float32)).to(tdt),
            torch.from_numpy(rows.astype(np.int32)), torch.from_numpy(wgt)))


def test_embedding_bag_wrapper_refuses_what_it_cannot_run():
    """The kernel wrapper checks before it builds or launches anything: a
    wrong type or shape, mixed devices and CPU tensors raise, and nothing
    is counted as a launch; the op raises on a mix of devices."""
    table = torch.zeros((10, 8))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    wgt = torch.ones((3, 2))
    before = kernels.launch_count("embedding_bag")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tkernel.embedding_bag(table.double(), idx, wgt)
    with pytest.raises(TypeError, match="int32"):
        tkernel.embedding_bag(table, idx.long(), wgt)
    with pytest.raises(TypeError, match="float32"):
        tkernel.embedding_bag(table, idx, wgt.bfloat16())
    with pytest.raises(ValueError, match="wgt"):
        tkernel.embedding_bag(table, idx, wgt[:, :1].contiguous())
    with pytest.raises(ValueError, match="is on meta"):
        tkernel.embedding_bag(table, idx.to("meta"), wgt)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.embedding_bag(table, idx, wgt)
    with pytest.raises(ValueError, match="expected all on the CPU"):
        embedding_bag(table, idx, wgt.to("meta"))
    assert kernels.launch_count("embedding_bag") == before
