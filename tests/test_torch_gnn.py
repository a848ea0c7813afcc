"""Port parity of the GNN family: ``repro_torch.graphs.sampler``,
``repro_torch.models.gnn.*`` against ``repro.graphs.sampler`` and
``repro.models.gnn.*`` on the same numpy inputs, with the reference's
weights (``MC.init_params``) carried across by ``convert.params``.

Tolerances, stated once:
- the sampler and the triplets: bit for bit (numpy on both sides);
- ``common``'s elementwise functions: float32 within 1e-6 (rtol and
  atol: the same ops, libm's rounding aside); the envelope and the radial
  basis that uses it within atol 1e-5, since near the cutoff the envelope
  is the sum of terms of up to 48 in magnitude that cancel to ~1e-3, and
  ``x ** 5`` is a product chain in JAX and ``pow`` in torch;
- ``scatter_sum`` / ``scatter_mean`` and their gradients: float32 within
  1e-6 (the sums run in another order);
- the models' ``loss_fn`` (float32): the loss within 1e-5 relative, each
  weight's gradient within 1e-4 of its largest magnitude; equiformer's
  bfloat16 ``act_dtype`` (its gathered node features round to bfloat16 on
  both sides, and the backward rounds their gradients there): loss and
  gradients within ``BF16_TOL`` = 2^-6, as the port's other bfloat16
  checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet_cfg as jdim
from repro.configs import equiformer_v2_cfg as jeq
from repro.configs import gatedgcn_cfg as jgg
from repro.configs import graphsage_reddit as jgs
from repro.graphs import generators as jgen
from repro.graphs import sampler as jsampler
from repro.models import common as JMC
from repro.models.gnn import common as JG
from repro.models.gnn import dimenet as JDN
from repro.models.gnn import equiformer_v2 as JEQ
from repro.models.gnn import gatedgcn as JGG
from repro.models.gnn import graphsage as JGS
from repro_torch import convert
from repro_torch.configs import dimenet_cfg as tdim
from repro_torch.configs import equiformer_v2_cfg as teq
from repro_torch.configs import gatedgcn_cfg as tgg
from repro_torch.configs import graphsage_reddit as tgs
from repro_torch.configs.smoke_runners import gnn_smoke_batch
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import sampler as tsampler
from repro_torch.models import common as MC
from repro_torch.models.gnn import common as G
from repro_torch.train.step import loss_and_grads

from _torch_jax import _release_jax_programs  # noqa: F401

BF16_TOL = 2.0 ** -6

#: arch: (reference config module, port config module, molecular, sampled)
ARCHS = {
    "graphsage": (jgs, tgs, False, True),
    "gatedgcn": (jgg, tgg, False, False),
    "dimenet": (jdim, tdim, True, False),
    "equiformer": (jeq, teq, True, False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree) -> dict:
    """A reference tree → {dotted path: leaf}."""
    return {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree.leaves_with_path(tree)}


def _close_to_max(got, want, tol: float, what: str = "",
                  floor: float = 1e-30) -> None:
    """max |got - want| within ``tol`` of want's largest magnitude (or of
    ``floor``, where that is larger)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), floor), what


# --------------------------------------------------------------------- #
# the sampler
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,deg,seeds,fanouts,pads", [
    (500, 8, 16, (5, 3), (600, 900)),
    (120, 6, 8, (4, 3), (160, 400)),
    (300, 4, 5, (10, 10), (None, None)),
])
def test_sample_fanout_matches_reference(n, deg, seeds, fanouts, pads):
    """Same graph, seeds and rng state: every array bit for bit, and the
    rng left in the same state."""
    out = []
    for gen, sampler in ((jgen, jsampler), (tgen, tsampler)):
        rng = np.random.default_rng(3)
        sub = sampler.sample_fanout(gen.rgg2d(n, avg_deg=deg, seed=1),
                                    np.arange(seeds), fanouts, rng=rng,
                                    pad_nodes=pads[0], pad_edges=pads[1])
        out.append((sub, rng.integers(1 << 30)))
    (want, w_next), (got, g_next) = out
    for f in ("node_ids", "row", "col"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.n_valid, got.n_seeds, got.n_sub) == \
        (want.n_valid, want.n_seeds, want.n_sub)
    assert g_next == w_next


def test_fanout_sampler_invariants():
    """``tests/test_misc.py``'s invariants on the port's sampler."""
    g = tgen.rgg2d(500, avg_deg=8, seed=0)
    sub = tsampler.sample_fanout(g, np.arange(16), (5, 3),
                                 rng=np.random.default_rng(0),
                                 pad_nodes=600, pad_edges=900)
    assert sub.n_seeds == 16
    assert (sub.node_ids[:sub.n_valid] >= 0).all()
    live = sub.row < sub.n_sub
    for r, c in zip(sub.row[live], sub.col[live]):
        u, v = int(sub.node_ids[r]), int(sub.node_ids[c])
        assert g.has_edge(u, v) or g.has_edge(v, u)
    assert np.bincount(sub.col[live]).max() <= 5


@pytest.mark.parametrize("budget,cap", [(200, 8), (5000, 8), (5000, 3)])
def test_build_triplets_matches_reference(budget, cap):
    """Bit for bit with the reference, and every triplet shares its pivot
    (in-edge k → j feeds out-edge j → i, k != i)."""
    g = tgen.rgg2d(80, avg_deg=6, seed=1)
    src = g.edge_sources().astype(np.int32)
    dst = g.indices.astype(np.int32)
    got = tsampler.build_triplets(src, dst, g.n, budget=budget,
                                  cap_per_edge=cap)
    want = jsampler.build_triplets(src, dst, g.n, budget=budget,
                                   cap_per_edge=cap)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    E = src.shape[0]
    real = got[got[:, 0] < E]
    assert (dst[real[:, 0]] == src[real[:, 1]]).all()
    assert (src[real[:, 0]] != dst[real[:, 1]]).all()


# --------------------------------------------------------------------- #
# common
# --------------------------------------------------------------------- #
def _dirs(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


ELEMENTWISE = {
    "layer_norm": lambda m, a: m.layer_norm(a[0], a[1], a[2]),
    "radial_basis": lambda m, a: m.radial_basis(a[3], 5, 5.0),
    "envelope": lambda m, a: m._envelope(a[3] / 5.0),
    "angular_basis": lambda m, a: m.angular_basis(a[4], 7),
    "spherical_harmonics": lambda m, a: m.spherical_harmonics_dirs(a[5], 6),
    "node_xent_loss": lambda m, a: m.node_xent_loss(a[0], a[6], a[7]),
}


@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_common_function_matches_reference(name):
    rng = np.random.default_rng(0)
    args = (rng.normal(size=(33, 12)).astype(np.float32),
            rng.normal(size=(12,)).astype(np.float32),
            rng.normal(size=(12,)).astype(np.float32),
            rng.uniform(0.0, 7.0, size=(40,)).astype(np.float32),
            rng.uniform(0.0, np.pi, size=(40,)).astype(np.float32),
            _dirs(rng, 40),
            rng.integers(0, 12, size=(33,)).astype(np.int32),
            (rng.random(33) < 0.7).astype(np.float32))
    want = ELEMENTWISE[name](JG, [jnp.asarray(a) for a in args])
    got = ELEMENTWISE[name](G, [torch.from_numpy(a) for a in args])
    atol = 1e-5 if name in ("envelope", "radial_basis") else 1e-6
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=atol)


def test_mlp_matches_reference():
    rng = np.random.default_rng(1)
    tree = JMC.init_params(JG.mlp_specs((6, 9, 4), prefix="m_"),
                           jax.random.key(0))
    x = rng.normal(size=(5, 6)).astype(np.float32)
    want = JG.mlp_apply(tree, jnp.asarray(x), 2, prefix="m_")
    model = MC.TreeModel(None, MC.nest(convert.params(tree)))
    got = G.mlp_apply(model, torch.from_numpy(x), 2, prefix="m_")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    assert set(G.mlp_specs((6, 9, 4), prefix="m_")) == set(tree)


def _segments(rng, n, E, pad):
    """E segment ids in [0, n), then ``pad`` padding entries on the
    sentinel n."""
    return np.concatenate([rng.integers(0, n, E), np.full(pad, n)]
                          ).astype(np.int32)


@pytest.mark.parametrize("n,E,pad,D", [(17, 120, 40, 5), (64, 9, 0, 1),
                                       (40, 300, 100, 0)])
def test_scatter_sum_and_mean_match_reference(n, E, pad, D):
    """Values and gradients (of Σ out · w) of ``scatter_sum`` and of
    ``scatter_mean`` with a mask, padding on the sentinel row; D = 0 is
    a 1-D payload."""
    rng = np.random.default_rng(n)
    seg = _segments(rng, n, E, pad)
    shape = (E + pad,) + ((D,) if D else ())
    vals = rng.normal(size=shape).astype(np.float32)
    mask = rng.random(E + pad) < 0.8
    w = rng.normal(size=(n,) + shape[1:]).astype(np.float32)
    plan = G.scatter_plan(torch.from_numpy(seg), n)
    for jfn, tfn in (
            (lambda v: JG.scatter_sum(v, jnp.asarray(seg), n),
             lambda v: G.scatter_sum(v, plan)),
            (lambda v: JG.scatter_mean(v, jnp.asarray(seg), n,
                                       mask=jnp.asarray(mask)),
             lambda v: G.scatter_mean(v, plan, mask=torch.from_numpy(mask)))):
        want, jgrad = jax.value_and_grad(
            lambda v: (jfn(v) * w).sum())(jnp.asarray(vals))
        tv = torch.from_numpy(vals).requires_grad_()
        got = (tfn(tv) * torch.from_numpy(w)).sum()
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(tfn(torch.from_numpy(vals))),
                                   _np(jfn(jnp.asarray(vals))), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(tv.grad), _np(jgrad), rtol=1e-6,
                                   atol=1e-6)


def test_scatter_plan_packs_live_entries_only():
    """Padding on the sentinel, masked entries and ids out of range are
    not packed (so they set no block's slot count) and get 0 gradient."""
    rng = np.random.default_rng(0)
    n, E = 50, 400
    seg = _segments(rng, n, E, 3000)
    live = rng.random(seg.shape[0]) < 0.5
    plan = G.scatter_plan(torch.from_numpy(seg), n, torch.from_numpy(live))
    keep = (seg < n) & live
    lrow = plan.lrow.numpy()
    assert (lrow < plan.r_blk).sum() == keep.sum()
    assert lrow.shape[1] <= np.bincount(seg[keep] // plan.r_blk).max()
    np.testing.assert_array_equal(plan.gather.numpy(),
                                  np.where(keep, seg, n))
    vals = torch.ones((seg.shape[0], 2), requires_grad=True)
    out = G.scatter_sum(vals, plan)
    np.testing.assert_array_equal(out[:, 0].detach().numpy(),
                                  np.bincount(seg[keep], minlength=n))
    out.sum().backward()
    np.testing.assert_array_equal(vals.grad[:, 0].numpy(), keep)
    # nothing live (a graph of isolated nodes): zeros, and no gradient
    dead = G.scatter_plan(torch.full((7,), n, dtype=torch.int32), n)
    vals = torch.ones((7, 3), requires_grad=True)
    out = G.scatter_sum(vals, dead)
    assert out.shape == (n, 3) and not out.detach().any()
    out.sum().backward()
    assert not vals.grad.any()


def test_scatter_max_matches_reference():
    rng = np.random.default_rng(2)
    seg = _segments(rng, 30, 50, 10)
    vals = rng.normal(size=(60, 3)).astype(np.float32)
    got = G.scatter_max(torch.from_numpy(vals), torch.from_numpy(seg), 30)
    want = JG.scatter_max(jnp.asarray(vals), jnp.asarray(seg), 30)
    np.testing.assert_array_equal(_np(got), _np(want))


# --------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------- #
#: name: (arch, port config changes, tolerance of loss and gradients)
MODEL_CASES = {
    "graphsage": ("graphsage", {}, None),
    "gatedgcn": ("gatedgcn", {}, None),
    "dimenet": ("dimenet", {}, None),
    "equiformer-bf16-act": ("equiformer", {}, BF16_TOL),
    "equiformer-f32-act": ("equiformer", {"act_dtype": "float32"}, None),
    "equiformer-gather-then-transform": (
        "equiformer", {"act_dtype": "float32",
                       "transform_then_gather": False}, None),
    "equiformer-edge-chunks": ("equiformer", {"act_dtype": "float32",
                                              "edge_chunk": 300}, None),
}
DTYPES = {"float32": (jnp.float32, torch.float32)}


def _configs(arch: str, changes: dict):
    jmod, tmod, molecular, sampled = ARCHS[arch]
    jc = {k: DTYPES.get(v, (v, v))[0] for k, v in changes.items()}
    tc = {k: DTYPES.get(v, (v, v))[1] for k, v in changes.items()}
    return (dataclasses.replace(jmod.SMOKE, **jc),
            dataclasses.replace(tmod.SMOKE, **tc), molecular, sampled)


def _reference_step(jmodel, jcfg, tree, batch):
    """The reference's loss and gradient tree on the numpy batch."""
    static = {k: v for k, v in batch.items() if not isinstance(v, np.ndarray)}
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, dict(b, **static), jcfg)))(tree,
                                                                   arrays)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_loss_and_grads_match_reference(case):
    """``loss_fn`` and every weight's gradient at the SMOKE config on the
    smoke runner's batch (the RGG of 120 nodes; graphsage's sampled
    subgraph with its padding), from the reference's weights."""
    arch, changes, tol = MODEL_CASES[case]
    jcfg, tcfg, molecular, sampled = _configs(arch, changes)
    jmodel = {"graphsage": JGS, "gatedgcn": JGG, "dimenet": JDN,
              "equiformer": JEQ}[arch]
    tmodel = ARCHS[arch][1].module
    batch = gnn_smoke_batch(tcfg, molecular=molecular, sampled=sampled)
    tree = JMC.init_params(jmodel.param_specs(jcfg), jax.random.key(1))
    jl, jgrads = _reference_step(jmodel, jcfg, tree, batch)
    tb = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    tl, tgrads = loss_and_grads(MC.nest(convert.params(tree)), tb, tcfg,
                                model_cls=tmodel.MODEL,
                                loss_fn=tmodel.loss_fn)
    got = dict(MC._leaves(tgrads))
    want = _flat(jgrads)
    assert set(got) == set(want)
    ltol = 1e-5 if tol is None else tol
    assert abs(float(tl) - float(jl)) <= ltol * abs(float(jl)), \
        (float(tl), float(jl))
    # a weight whose exact gradient is 0 holds rounding noise on both
    # sides (equiformer's w_att_dst: a destination's score offset cancels
    # in its softmax; ~1e-18): held to 1e-6 of the model's largest gradient
    floor = 1e-6 * max(float(np.abs(_np(w)).max()) for w in want.values())
    for k, w in want.items():
        _close_to_max(got[k], w, 1e-4 if tol is None else tol, k, floor)


def test_model_plans_keep_padding_out_of_the_blocks():
    """DimeNet's padding triplets (clamped onto edge E - 1 by the
    reference) and the sampled subgraph's padding edges (on the sentinel)
    are not packed: each plan's slot budget is the real entries' largest
    row block."""
    _, tcfg, _, _ = _configs("dimenet", {})
    nb = gnn_smoke_batch(tcfg, molecular=True)
    E = nb["row"].shape[0]
    nb["triplets"] = tsampler.build_triplets(nb["row"], nb["col"],
                                             nb["node_feat"].shape[0],
                                             budget=8 * E)
    batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in nb.items()}
    tri = nb["triplets"]
    real = tri[(tri[:, 0] < E) & (tri[:, 1] < E)]
    assert real.shape[0] < tri.shape[0]   # the budget holds padding
    plan = tdim.module.plans(batch, tcfg)["to"]
    assert plan.lrow.shape[1] == np.bincount(real[:, 1] // plan.r_blk).max()
    sb = gnn_smoke_batch(tgs.SMOKE, molecular=False, sampled=True)
    n = sb["node_feat"].shape[0]
    assert (sb["row"] == n).any()
    plan = tgs.module.plans({k: torch.from_numpy(v) for k, v in sb.items()},
                            tgs.SMOKE)["col"]
    live = sb["col"][sb["row"] < n]
    assert plan.lrow.shape[1] == np.bincount(live // plan.r_blk).max()
