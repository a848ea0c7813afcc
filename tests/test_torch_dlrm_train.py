"""Port parity of DLRM training: the ``embedding_bag`` op's backward and
``models.dlrm.loss_fn`` under autograd, against ``jax.grad`` of
``repro.kernels.embedding_bag.ref.embedding_bag_ref`` and
``jax.value_and_grad`` of ``repro.models.dlrm.loss_fn``, on the same
numpy inputs and the reference's weights (``convert.params``).

Tolerances, stated once:
- the table's gradient: float32 within 1e-6 of its largest entry (both
  sides sum the same terms in float32, in other orders); bfloat16 within
  2^-6 of its largest entry (the port accumulates in float32 and rounds
  once; JAX's scatter adds each term into the bfloat16 gradient, rounding
  every time);
- the weights' gradient: float32 within 1e-6 (rtol and atol); bfloat16
  tables within 1e-5 (the rows are exact in both; only the sum's order
  differs);
- DLRM's loss within 1e-5 relative, every weight's gradient within 1e-4
  of its largest magnitude; NaN where the reference has NaN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_mlperf as jcfgs
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jref
from repro.models import common as JMC
from repro.models import dlrm as JD
from repro_torch import convert, kernels
from repro_torch.configs import dlrm_mlperf as tcfgs
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_bwd_ref
from repro_torch.models import common as MC
from repro_torch.models import dlrm as TD
from repro_torch.train.step import loss_and_grads

from _torch_jax import _release_jax_programs  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6, 1e-5)}


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


def _t(a, dtype=None) -> torch.Tensor:
    t = convert.params({"a": a})["a"]
    return t if dtype is None else t.to(dtype)


def _bag_case(V, B, K, D, jdt, seed, ids=()):
    """A table, ids (the given out-of-range ones first, then uniform in
    [0, V)), weights and a cotangent, numpy float32 / int32."""
    rng = np.random.default_rng(seed)
    table = np.asarray(jnp.asarray(rng.normal(size=(V, D)), jdt))
    idx = rng.integers(0, V, size=(B, K)).astype(np.int32)
    idx.reshape(-1)[:len(ids)] = ids
    wgt = rng.normal(size=(B, K)).astype(np.float32)
    cot = np.asarray(jnp.asarray(rng.normal(size=(B, D)), jdt))
    return table, idx, wgt, cot


@pytest.mark.parametrize("V,B", [(37, 29), (3, 2048)])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embedding_bag_backward_matches_jax_grad(dtype, K, V, B):
    """The table's and the weights' gradients of Σ out · cot, with ids V,
    V+3, -1, -V and -V-1 among the lookups: JAX drops the cotangent of an
    id still out of range after the wrap (V, V+3, -V-1), so its row gets
    nothing from it; the weights' gradient reads the row the forward read
    (wrap, then clamp).  V 3 at B 2,048 puts every lookup on three rows
    (DLRM's hot rows), and at K 4 a row appears more than once in a bag.
    JAX's bfloat16 scatter rounds after every add, so a row of hundreds of
    lookups drifts from the float32 sum rounded once that the port
    computes (``embedding_bag``'s docstring): on hot rows a bfloat16 table
    is held to JAX's gradient of the same values in float32, rounded to
    bfloat16 once (the weights' gradient is the same either way)."""
    jdt, tdt, tol, wtol = DTYPES[dtype]
    D = 16
    table, idx, wgt, cot = _bag_case(V, B, K, D, jdt, seed=K,
                                     ids=(V, V + 3, -1, -V, -V - 1))
    gdt = jnp.float32 if B > 100 * V else jdt

    def f(t, w):
        return (jref(t, jnp.asarray(idx), w).astype(jnp.float32)
                * jnp.asarray(cot).astype(jnp.float32)).sum()

    jg_t, jg_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(table, gdt),
                                             jnp.asarray(wgt))
    jg_t = jg_t.astype(jdt)
    tt = _t(table, tdt).requires_grad_()
    tw = torch.from_numpy(wgt).requires_grad_()
    out = embedding_bag(tt, torch.from_numpy(idx), tw)
    (out.float() * _t(cot, tdt).float()).sum().backward()
    assert tt.grad.dtype == tdt
    g, w = _np(tt.grad), _np(jg_t)
    assert np.abs(g - w).max() <= tol * np.abs(w).max()
    np.testing.assert_allclose(_np(tw.grad), _np(jg_w), rtol=wtol, atol=wtol)


def test_dropped_ids_add_nothing_whatever_their_weight():
    """An id out of range after the wrap adds nothing to any row, even
    with a NaN weight (DLRM's lookup gives such an id weight NaN); an id
    in [-V, -1] adds to its wrapped row."""
    V, D = 4, 3
    idx = torch.tensor([[5], [-1], [-6], [1], [-5]], dtype=torch.int32)
    wgt = torch.tensor([[float("nan")], [2.0], [float("nan")], [1.0],
                        [float("nan")]])
    cot = torch.ones((5, D))
    got = embedding_bag_bwd_ref(cot, idx, wgt, V, torch.float32)
    want = torch.zeros((V, D))
    want[3] = 2.0
    want[1] = 1.0
    assert torch.equal(got, want)


def test_only_the_needed_gradients_are_computed():
    """``needs_input_grad``: no weights' gradient for constant weights
    (DLRM's), no table gradient for a frozen table; no kernel launches on
    CPU tensors."""
    table, idx, wgt, _ = _bag_case(10, 6, 2, 4, jnp.float32, seed=0)
    before = {k: kernels.launch_count(k) for k in kernels.KERNELS}
    t = torch.from_numpy(table).requires_grad_()
    w = torch.from_numpy(wgt)
    embedding_bag(t, torch.from_numpy(idx), w).sum().backward()
    assert t.grad is not None and w.grad is None
    t = torch.from_numpy(table)
    w = torch.from_numpy(wgt).requires_grad_()
    embedding_bag(t, torch.from_numpy(idx), w).sum().backward()
    assert t.grad is None and w.grad is not None
    assert before == {k: kernels.launch_count(k) for k in kernels.KERNELS}


def _dlrm_case(cfg, B: int, seed: int, out_of_range: bool):
    rng = np.random.default_rng(seed)
    sparse = np.stack([rng.integers(0, v, B) for v in cfg.vocabs],
                      axis=1).astype(np.int32)
    sparse[1::3, 5] = -sparse[1::3, 5] - 1    # ids in [-V, -1] wrap
    if out_of_range:
        sparse[1, 5] = cfg.vocabs[5]          # table 5: 3 rows
    return dict(dense=rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
                sparse=sparse,
                labels=rng.integers(0, 2, size=B).astype(np.int32))


def _flat(tree) -> dict:
    return {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree.leaves_with_path(tree)}


@pytest.mark.parametrize("out_of_range", [False, True])
def test_dlrm_loss_and_grads_match_reference(out_of_range):
    """SMOKE widths, weights x 8 (logits of order one), negative ids that
    wrap; with ``out_of_range`` one id of table 5 is its V: the forward
    gives that sample a NaN row, so the loss and every gradient the
    sample reaches are NaN, as the reference's, but table 5's gradient
    takes nothing from the id (JAX drops it): finite and equal."""
    jcfg, tcfg = jcfgs.SMOKE, tcfgs.SMOKE
    tree = jax.tree.map(lambda a: a * 8.0,
                        JMC.init_params(JD.param_specs(jcfg),
                                        jax.random.key(0)))
    b = _dlrm_case(jcfg, 24, seed=3, out_of_range=out_of_range)
    jl, jg = jax.value_and_grad(lambda p: JD.loss_fn(
        p, {k: jnp.asarray(v) for k, v in b.items()}, jcfg))(tree)
    tl, tg = loss_and_grads(MC.nest(convert.params(tree)),
                            {k: torch.from_numpy(v) for k, v in b.items()},
                            tcfg, model_cls=TD.DLRM, loss_fn=TD.loss_fn)
    got, want = dict(MC._leaves(tg)), _flat(jg)
    assert set(got) == set(want)
    if out_of_range:
        assert np.isnan(float(jl)) and np.isnan(float(tl))
        assert np.isfinite(_np(want["tables.t5"])).all()
    else:
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k, w in want.items():
        g, w = _np(got[k]), _np(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        fin = ~np.isnan(w)
        scale = max(np.abs(w[fin]).max(initial=0.0), 1e-30)
        assert np.abs(g[fin] - w[fin]).max(initial=0.0) <= 1e-4 * scale, k


def test_trainable_dlrm_serves_the_same_bits():
    """A trainable model's forward is the served one's, bit for bit (the
    op's forward is unchanged; only the weights take gradients)."""
    cfg = dataclasses.replace(tcfgs.SMOKE)
    params = MC.init_params(TD.param_specs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in
         _dlrm_case(cfg, 16, seed=1, out_of_range=False).items()}
    with torch.no_grad():
        want = TD.serve_step(TD.DLRM(cfg, params), b, cfg)
    got = TD.serve_step(TD.DLRM(cfg, params, trainable=True), b, cfg)
    assert got.requires_grad and torch.equal(got.detach(), want)


def test_train_step_leaves_no_cycle_holding_tensors():
    """A step's old weights and moments are freed when the caller drops
    them, not when the cyclic collector next runs: at DLRM's capped
    widths on the card that is 20 GB (the optimizer's tree rebuild was a
    recursive closure, a cycle that held every leaf)."""
    import gc

    from repro_torch.configs.smoke_runners import dlrm_smoke_batches
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import train_step

    cfg = tcfgs.SMOKE
    params = MC.init_params(TD.param_specs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in
         dlrm_smoke_batches(cfg)[0].items()}
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        out = train_step(params, opt.adamw_init(params), b, cfg,
                         opt.adamw_update, opt.AdamWConfig(),
                         model_cls=TD.MODEL, loss_fn=TD.loss_fn)
        del out
        gc.collect()
        held = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not held, f"{len(held)} tensors held by reference cycles"
