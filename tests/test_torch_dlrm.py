"""Port parity of DLRM serving: ``repro_torch.models.dlrm`` against
``repro.models.dlrm`` with the reference's weights (``MC.init_params``)
carried across by ``convert.params``, on the same ``dlrm_batch`` inputs.

Configs: the SMOKE config, and the full MLPerf widths (embed 128, bot
13-512-256-128, top 479-1024-1024-512-256-1, 26 tables) with every
vocabulary capped at 64 rows.  Float32 tolerance: rtol 1e-5, atol 1e-6.
The lookups equal ``jnp.take`` exactly; on CPU tensors they go through the
``embedding_bag`` op's plain version and launch no kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_mlperf as jcfgs
from repro.data import pipeline as jp
from repro.models import common as JMC
from repro.models import dlrm as JD
from repro_torch import convert, kernels
from repro_torch.configs import dlrm_mlperf as tcfgs
from repro_torch.models import common as MC
from repro_torch.models import dlrm as TD

from _torch_jax import _release_jax_programs  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capped(cfg, rows=64):
    return dataclasses.replace(
        cfg, vocabs=tuple(min(v, rows) for v in cfg.vocabs))


#: name: (reference config, port config, the weight scale that takes the
#: logits from the init's ~1e-5 to order one: 2 at most, mean 0.4-0.7)
CONFIGS = {
    "smoke": (jcfgs.SMOKE, tcfgs.SMOKE, 8.0),
    "full-widths-64-rows": (_capped(jcfgs.CONFIG), _capped(tcfgs.CONFIG),
                            4.0),
}


def _models(name: str, unit: bool, key: int = 0):
    """The reference's tree (as initialised, or every leaf times the
    config's unit scale) and the port's model holding it."""
    jcfg, tcfg, scale = CONFIGS[name]
    scale = scale if unit else 1.0
    tree = JMC.init_params(JD.param_specs(jcfg), jax.random.key(key))
    tree = jax.tree.map(lambda a: a * scale, tree)
    model = TD.DLRM(tcfg, MC.init_params(
        TD.param_specs(tcfg), torch.Generator().manual_seed(0), "cpu"))
    model.load_state_dict(convert.params(tree), strict=True)
    return jcfg, tcfg, tree, model


def _batch(cfg, step: int, b: int = 24) -> dict:
    return jp.dlrm_batch(jp.DLRMBatchSpec(b, cfg.n_dense, cfg.n_sparse,
                                          cfg.vocabs, seed=1), step)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_config_copies_are_the_reference():
    for name in ("CONFIG", "SMOKE"):
        j, t = getattr(jcfgs, name), getattr(tcfgs, name)
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        # the one field the port leaves out: nothing reads it
        assert {f.name for f in dataclasses.fields(j)} - \
            {f.name for f in dataclasses.fields(t)} == {"interaction"}
        assert j.interaction == "dot"
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        assert (t.n_interactions, t.top_in) == (j.n_interactions, j.top_in)


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_param_specs_are_the_reference(name):
    """Shapes (the >= 4096-row tables padded to 512), inits and scales,
    leaf for leaf; no tensor is allocated."""
    j = jax.tree.leaves_with_path(
        JD.param_specs(getattr(jcfgs, name)),
        is_leaf=lambda x: isinstance(x, JMC.ParamSpec))
    t = dict(MC._leaves(TD.param_specs(getattr(tcfgs, name))))
    assert len(j) == len(t)
    for path, s in j:
        ts = t[".".join(k.key for k in path)]
        assert (ts.shape, ts.init, ts.scale) == (s.shape, s.init, s.scale)
        assert ts.dtype == torch.float32
    assert MC.count_params(TD.param_specs(getattr(tcfgs, name))) == \
        JMC.count_params(JD.param_specs(getattr(jcfgs, name)))


def test_mlperf_tables_pad_as_the_reference():
    """The full tables, and the tables capped at 10,000,000 rows that the
    card holds (the five capped ones pad to 10,000,384 rows)."""
    def rows(module, cfg):
        return sum(s.shape[0] for s in module.param_specs(cfg)["tables"]
                   .values())

    assert rows(TD, tcfgs.CONFIG) == rows(JD, jcfgs.CONFIG) == 187_770_880
    cap = tuple(min(v, 10_000_000) for v in TD.MLPERF_VOCABS)
    assert rows(TD, dataclasses.replace(tcfgs.CONFIG, vocabs=cap)) == rows(
        JD, dataclasses.replace(jcfgs.CONFIG, vocabs=cap)) == 54_068_224


@pytest.mark.parametrize("unit", [False, True], ids=["init", "unit-logits"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_serve_loss_match_reference(name, unit):
    jcfg, tcfg, tree, model = _models(name, unit)
    fwd = jax.jit(lambda p, b: JD.forward(p, b, jcfg))
    serve = jax.jit(lambda p, b: JD.serve_step(p, b, jcfg))
    loss = jax.jit(lambda p, b: JD.loss_fn(p, b, jcfg))
    for step in range(3):
        b = _batch(jcfg, step)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        with torch.no_grad():
            _close(TD.forward(model, tb, tcfg), fwd(tree, jb))
            _close(model(tb), fwd(tree, jb))
            _close(TD.serve_step(model, tb, tcfg), serve(tree, jb))
            _close(TD.loss_fn(model, tb, tcfg), loss(tree, jb))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_retrieval_step_matches_reference(name):
    jcfg, tcfg, tree, model = _models(name, True, key=3)
    rng = np.random.default_rng(4)
    b = dict(dense=rng.normal(size=(1, jcfg.n_dense)).astype(np.float32),
             candidates=rng.integers(0, jcfg.vocabs[0], size=(1, 200))
             .astype(np.int32))
    want = JD.retrieval_step(tree, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg)
    with torch.no_grad():
        got = TD.retrieval_step(
            model, {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    assert got.shape == (200,)
    _close(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lookups_equal_take_and_launch_nothing_on_cpu(name):
    jcfg, tcfg, tree, model = _models(name, False)
    b = _batch(jcfg, 5)
    kernels.reset_launch_counts()
    for i in range(tcfg.n_sparse):
        idx = b["sparse"][:, i]
        want = np.asarray(jnp.take(tree["tables"][f"t{i}"],
                                   jnp.asarray(idx), axis=0))
        got = TD.embedding_bag(getattr(model.tables, f"t{i}"),
                               torch.from_numpy(b["sparse"])[:, i])
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), i
    with torch.no_grad():
        model({k: torch.from_numpy(v) for k, v in b.items()})
    assert all(kernels.launch_count(k) == 0 for k in kernels.KERNELS)


def _odd_ids(V: int) -> np.ndarray:
    return np.array([V, V + 3, -1, -V, -V - 1], np.int32)


def _same_nan_and_close(got: torch.Tensor, want) -> None:
    """NaN exactly where the reference has NaN, the rest within the
    float32 tolerance."""
    g, w = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)], rtol=RTOL,
                               atol=ATOL)


def test_out_of_range_ids_give_take_s_rows():
    """``jnp.take`` wraps an id in [-V, -1] and gives a NaN row for one
    outside [-V, V) (V the padded table height): ids V, V + 3, -1, -V and
    -V - 1 in one sparse column of the forward, and as retrieval
    candidates, give the reference's NaN / wrapped results."""
    jcfg, tcfg, tree, model = _models("smoke", True)
    b = _batch(jcfg, 6, b=5)
    V = int(tree["tables"]["t4"].shape[0])
    b["sparse"][:, 4] = _odd_ids(V)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    lookup = TD.embedding_bag(model.tables.t4, tb["sparse"][:, 4])
    want = np.asarray(jnp.take(tree["tables"]["t4"], jb["sparse"][:, 4],
                               axis=0))
    assert np.array_equal(np.isnan(lookup.numpy()), np.isnan(want))
    assert np.isnan(want[[0, 1, 4]]).all() and not np.isnan(want[2:4]).any()
    assert np.array_equal(lookup.numpy()[2:4], want[2:4])
    with torch.no_grad():
        _same_nan_and_close(TD.serve_step(model, tb, tcfg),
                            JD.serve_step(tree, jb, jcfg))
    V0 = int(tree["tables"]["t0"].shape[0])
    rb = dict(dense=b["dense"][:1], candidates=np.concatenate(
        [_odd_ids(V0), np.arange(3, dtype=np.int32)])[None])
    want = JD.retrieval_step(tree, {k: jnp.asarray(v) for k, v in rb.items()},
                             jcfg)
    with torch.no_grad():
        got = TD.retrieval_step(
            model, {k: torch.from_numpy(v) for k, v in rb.items()}, tcfg)
    _same_nan_and_close(got, want)
    assert np.isnan(np.asarray(want)[[0, 1, 4]]).all()


def test_state_dict_keys_are_the_tree_paths():
    _, tcfg, tree, model = _models("smoke", False)
    keys = list(model.state_dict())
    assert set(keys) == set(convert.params(tree))
    assert {"tables.t0", "tables.t25", "bot_w0", "bot_b1", "top_w2",
            "top_b2"} <= set(keys)
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict({k: v for k, v in convert.params(tree).items()
                               if k != "top_b0"}, strict=True)
