"""The hand-written CUDA kernel on the card: held against its plain torch
version, exactly, and the ``cuda`` backend's solve against the CPU run.

Needs a CUDA card (marker ``gpu``); skips on a CPU-only machine.  On the
card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.core import partition as part
from repro_torch.core import solvers as S
from repro_torch.graphs import generators as gen
from repro_torch.kernels.segment_coo import kernel as K
from repro_torch.kernels.segment_coo.ops import (
    pack_blocks, segment_fused_coo, segment_fused_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n_rows,n_edges,r_blk,widths,nbits", [
    (17, 120, 8, (2, 2, 1, 0), 16),
    (64, 9, 8, (2, 2, 1, 0), 16),
    (23, 77, 8, (0, 3, 0, 0), 16),
    (17, 120, 8, (1, 0, 0, 2), 12),
    (64, 9, 8, (0, 0, 0, 2), 5),
    (40, 300, 64, (2, 2, 0, 2), 8),
    (5000, 40000, 64, (2, 2, 1, 2), 16),
])
def test_kernel_matches_plain(cuda, n_rows, n_edges, r_blk, widths, nbits):
    rng = np.random.default_rng(0)
    row = np.sort(rng.integers(0, n_rows, size=n_edges)).astype(np.int32)
    perm, lrow, _ = pack_blocks(row, n_rows, r_blk=r_blk, e_blk_multiple=8)
    names = ("data_sum", "data_max", "data_min", "data_or")
    data = {
        k: torch.from_numpy(
            rng.integers(-(1 << 20), 1 << 20, size=(n_edges, d))
            .astype(np.int32)).to(cuda)
        for k, d in zip(names, widths) if d
    }
    perm = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    lrow = torch.from_numpy(lrow).to(cuda)
    before = K.launch_count()
    got = segment_fused_coo(perm, lrow, n_rows, r_blk=r_blk, or_nbits=nbits,
                            **data)
    torch.cuda.synchronize()
    assert K.launch_count() == before + 1
    want = segment_fused_plain(perm, lrow, n_rows, r_blk=r_blk,
                               or_nbits=nbits, **data)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def test_kernel_rejects_other_dtypes(cuda):
    perm = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    lrow = torch.full((1, 8), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        K.segment_fused(perm, lrow, 8, r_blk=8,
                        data_sum=torch.zeros((1, 1), device=cuda))


@pytest.mark.parametrize("algo,mode", [("reduce", "async"), ("rnp", "sync"),
                                       ("rg", "async")])
def test_cuda_solve_matches_cpu(cuda, algo, mode):
    """The whole union path on the card (kernel backend) == the CPU run of
    the port (plain version), bit for bit."""
    g = gen.rgg2d(3000, avg_deg=8, seed=4)
    pg = part.partition_graph(g, 4, window_cap=16)
    cfg = D.DisReduConfig(mode=mode, schedule="cheap-fused", backend="cuda")
    if algo == "reduce":
        gs, _, gr = D.disredu(pg, cfg, device=cuda)
        cs, _, cr = D.disredu(pg, cfg, device="cpu")
        assert gr == cr
    else:
        before = K.launch_count()
        gm, gs = S.solve(pg, algo, cfg, device=cuda)
        assert K.launch_count() > before
        cm, cs = S.solve(pg, algo, cfg, device="cpu")
        np.testing.assert_array_equal(gm, cm)
        assert g.is_independent_set(gm)
    for f in ("w", "status", "log_kind", "log_v", "log_u", "log_n",
              "offset"):
        assert torch.equal(getattr(gs, f).cpu(), getattr(cs, f)), f
