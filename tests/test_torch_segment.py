"""Port parity: the fused segment reduction's plain torch version against the
JAX Pallas kernel (interpret mode) and its ops wrapper, bit for bit.

All payloads are int32, so the tolerance is exactly zero everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.kernels.segment_coo import ops as jops
from repro.kernels.segment_coo.kernel import segment_fused_blocked
from repro.kernels.segment_coo.ref import (
    segment_fused_blocked_ref as jax_blocked_ref,
)
from repro_torch import convert, kernels
from repro_torch.core import engine as TE
from repro_torch.kernels.segment_coo import kernel as tkernel
from repro_torch.kernels.segment_coo import ops as tops
from repro_torch.kernels.segment_coo.ref import (
    live_extent, segment_fused_blocked_ref, segment_max, segment_min,
    segment_or_ref, segment_sum,
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


# --------------------------------------------------------------------- #
# live extents: derived beside the plan, never in place of its arrays
# --------------------------------------------------------------------- #


def _recount(lrow, r_blk):
    """One past the last live slot (0 <= lrow < r_blk) of each row block,
    counted block by block in numpy."""
    lrow = np.asarray(lrow)
    out = np.zeros(lrow.shape[:-1], dtype=np.int64)
    for k in np.ndindex(*lrow.shape[:-1]):
        live = np.flatnonzero((lrow[k] >= 0) & (lrow[k] < r_blk))
        out[k] = live[-1] + 1 if live.size else 0
    return out


def _nil_heavy_rows(rng, n_rows, n_edges, share=0.8):
    """Sorted rows with ``share`` of the edges on the last row, as a
    partition pads its edge array with edges on its nil row."""
    row = rng.integers(0, n_rows, size=n_edges)
    row[: int(n_edges * share)] = n_rows - 1
    return np.sort(row).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("r_blk", [8, 16, 64])
def test_live_extent_from_every_plan_function(seed, r_blk):
    """build_plan / pad_plan / stack_plans / convert.seg_plan carry the
    extent a numpy recount from lrow gives (for pack_blocks plans: each
    block's edge count), while edge_perm and lrow stay the JAX package's
    arrays, padded and stacked alike."""
    rng = np.random.default_rng(seed)
    n_rows = 200 + 37 * seed
    rows = [_nil_heavy_rows(rng, n_rows, 900), np.sort(
        rng.integers(0, n_rows, size=900)).astype(np.int32)]
    jplans = [JE.build_plan(r, n_rows, r_blk=r_blk) for r in rows]
    tplans = [TE.build_plan(r, n_rows, r_blk=r_blk) for r in rows]
    for r, jp, tp in zip(rows, jplans, tplans):
        np.testing.assert_array_equal(tp.edge_perm.numpy(),
                                      np.asarray(jp.edge_perm))
        np.testing.assert_array_equal(tp.lrow.numpy(), np.asarray(jp.lrow))
        assert tp.extent.dtype == torch.int32
        np.testing.assert_array_equal(tp.extent.numpy(),
                                      _recount(tp.lrow, r_blk))
        np.testing.assert_array_equal(
            tp.extent.numpy(),
            np.bincount(r // r_blk, minlength=tp.lrow.shape[0]))
        conv = convert.seg_plan(jp)
        np.testing.assert_array_equal(conv.extent.numpy(),
                                      tp.extent.numpy())
    e_blk = max(p.edge_perm.shape[1] for p in tplans) + 24
    jpad = JE.pad_plan(jplans[0], e_blk)
    tpad = TE.pad_plan(tplans[0], e_blk)
    np.testing.assert_array_equal(tpad.lrow.numpy(), np.asarray(jpad.lrow))
    np.testing.assert_array_equal(tpad.extent.numpy(),
                                  _recount(tpad.lrow, r_blk))
    jst = JE.stack_plans(jplans, e_blk=e_blk, batch_multiple=4)
    tst = TE.stack_plans(tplans, e_blk=e_blk, batch_multiple=4)
    np.testing.assert_array_equal(tst.edge_perm.numpy(),
                                  np.asarray(jst.edge_perm))
    np.testing.assert_array_equal(tst.lrow.numpy(), np.asarray(jst.lrow))
    assert tst.extent.shape == (4, tplans[0].lrow.shape[0])
    np.testing.assert_array_equal(tst.extent.numpy(),
                                  _recount(tst.lrow, r_blk))


def _hand_plan(rng, n_rows, r_blk, e_blk):
    """A plan built by hand, not by pack_blocks: live slots in any order,
    padding (r_blk, negative, or above r_blk) between them and after them,
    and a block with no live slot at all."""
    n_blocks = -(-n_rows // r_blk)
    lrow = rng.integers(0, r_blk, size=(n_blocks, e_blk)).astype(np.int32)
    pad = rng.random((n_blocks, e_blk)) < 0.3
    lrow[pad] = rng.choice(np.array([r_blk, -1, r_blk + 5], np.int32),
                           size=int(pad.sum()))
    lrow[0, e_blk // 2:] = r_blk            # a tail of padding
    lrow[1] = -1                            # a block with no live slot
    lrow[-1][lrow[-1] >= n_rows - (n_blocks - 1) * r_blk] = r_blk
    n_edges = 3 * e_blk
    perm = rng.integers(0, n_edges, size=(n_blocks, e_blk)).astype(np.int32)
    return perm, lrow, n_edges


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_extent_of_a_plan_with_padding_inside_blocks(seed):
    """On a hand-made plan the extent is one past the last live slot (not a
    count of live slots), and the dispatching op, given it or not, equals
    the JAX package's blocked oracle on the payloads gathered through the
    plan (it drops every local row outside [0, r_blk)) and per-row
    reductions over the live slots alone."""
    rng = np.random.default_rng(seed)
    n_rows, r_blk, e_blk = 45, 8, 40
    perm, lrow, n_edges = _hand_plan(rng, n_rows, r_blk, e_blk)
    ext = live_extent(torch.from_numpy(lrow), r_blk)
    want_ext = _recount(lrow, r_blk)
    np.testing.assert_array_equal(ext.numpy(), want_ext)
    assert want_ext[0] <= e_blk // 2 and want_ext[1] == 0
    assert (want_ext > ((lrow >= 0) & (lrow < r_blk)).sum(1)).any()

    widths = (2, 2, 1, 2)
    _, groups = _case(seed, n_rows, n_edges, widths)
    names = ("data_sum", "data_max", "data_min", "data_or")
    data = {k: torch.from_numpy(g) for k, g in zip(names, groups)}
    live = (lrow >= 0) & (lrow < r_blk)
    rows = (np.arange(lrow.shape[0])[:, None] * r_blk + lrow)[live]
    edges = perm[live]
    seg = torch.from_numpy(rows.astype(np.int64))
    blk = [jnp.asarray(_blocked(g, perm)) for g in groups]
    oracle = jax_blocked_ref(*blk[:3], jnp.asarray(lrow), r_blk=r_blk,
                             data_or=blk[3], or_nbits=16)
    oracle = [np.asarray(o).reshape(-1, o.shape[-1])[:n_rows]
              for o in oracle]
    for extent in (None, ext):
        got = tops.segment_fused_coo(
            torch.from_numpy(perm), torch.from_numpy(lrow), n_rows,
            r_blk=r_blk, or_nbits=16, extent=extent, **data)
        _assert_groups_equal(got, oracle)
        for k, op in enumerate((segment_sum, segment_max, segment_min)):
            np.testing.assert_array_equal(
                got[k].numpy(),
                op(torch.from_numpy(groups[k][edges]), seg, n_rows).numpy())
        np.testing.assert_array_equal(
            got[3].numpy(),
            segment_or_ref(torch.from_numpy(groups[3][edges]), seg, n_rows,
                           nbits=16).numpy())


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("backend", ["blocked", "cuda"])
def test_aggregate_on_a_nil_heavy_plan_matches_reference(backend, batch):
    """aggregate (batch 0) and aggregate_batched on the blocked backends
    (CPU tensors: the plain version) over plans with 80 % of the edges on
    one row == the JAX package's jnp backend."""
    rng = np.random.default_rng(11 + batch)
    n_rows, n_edges, r_blk = 69, 1024, 8
    seg = _nil_heavy_rows(rng, n_rows, n_edges)
    lead = (batch,) if batch else ()
    dsum = rng.integers(-1000, 1000, size=lead + (n_edges, 2)).astype(np.int32)
    dmax = rng.integers(-1000, 1000, size=lead + (n_edges,)).astype(np.int32)
    dmin = rng.integers(-1000, 1000, size=lead + (n_edges, 1)).astype(np.int32)
    dor = rng.integers(0, 1 << 12, size=lead + (n_edges, 2)).astype(np.int32)
    kw = dict(data_sum=dsum, data_max=dmax, data_min=dmin, data_or=dor)
    tplan = TE.build_plan(seg, n_rows, r_blk=r_blk)
    if batch:
        tplan = TE.stack_plans([tplan] * batch)
        seg_in = np.broadcast_to(seg, (batch, n_edges)).copy()
        want = JE.aggregate_batched(
            jnp.asarray(seg_in), n_rows, or_nbits=12, backend="jnp",
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = TE.aggregate_batched(
            None, n_rows, or_nbits=12, backend=backend, plan=tplan,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    else:
        want = JE.aggregate(jnp.asarray(seg), n_rows, or_nbits=12,
                            backend="jnp",
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = TE.aggregate(None, n_rows, or_nbits=12, backend=backend,
                           plan=tplan,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    _assert_groups_equal(got, want)


def test_kernel_wrapper_checks_the_extent():
    """An extent of the wrong shape, type or device raises before anything
    is built or launched."""
    row, (dsum, _, _, _) = _case(1, 9, 20, (1, 0, 0, 0))
    perm, lrow, _ = tops.pack_blocks(row, 9, r_blk=8)
    perm = torch.from_numpy(perm.astype(np.int32))
    lrow = torch.from_numpy(lrow)
    data = torch.from_numpy(dsum)
    before = kernels.launch_count("segment_fused")
    for bad, match in ((torch.zeros(5, dtype=torch.int32), "row blocks"),
                       (torch.zeros(2, dtype=torch.int64), "int32"),
                       (torch.zeros((2, 1), dtype=torch.int32), "1-D")):
        with pytest.raises((ValueError, TypeError), match=match):
            tkernel.segment_fused(perm, lrow, 9, r_blk=8, data_sum=data,
                                  extent=bad)
    with pytest.raises(ValueError, match="expected all on the CPU"):
        tops.segment_fused_coo(perm, lrow, 9, r_blk=8, data_sum=data,
                               extent=torch.zeros(2, dtype=torch.int32,
                                                  device="meta"))
    assert kernels.launch_count("segment_fused") == before
