"""Port parity of LM decode: ``repro_torch.models.{common,transformer}``
against ``repro.models.{common,transformer}`` on the same numpy inputs,
with the reference's weights (``MC.init_params``) carried across by
``convert.params``.

Tolerances, stated once:
- float32: the numerics within 1e-5 (rtol and atol); ``serve_step``'s
  logits within 1e-4 of the largest logit, greedy tokens equal, caches
  within rtol 1e-5 / atol 1e-6 (the projections' sums run in another
  order) and the slots no step writes exactly equal;
- bfloat16: ``BF16_TOL`` = 2^-6 relative (four bfloat16 ulps: both sides
  compute in float32 and round where the reference rounds, so a value
  can land one ulp apart, and a step's rounding carries into the next
  layer); logits within it of the largest logit, greedy tokens equal
  wherever the reference's top-2 gap exceeds twice that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as jg
from repro.configs import grok1_314b as jgk
from repro.configs import mistral_nemo_12b as jm
from repro.configs import qwen3_32b as jq
from repro.configs import qwen3_moe_235b as jqm
from repro.models import common as JMC
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import gemma3_1b as tg
from repro_torch.configs import grok1_314b as tgk
from repro_torch.configs import mistral_nemo_12b as tm
from repro_torch.configs import qwen3_32b as tq
from repro_torch.configs import qwen3_moe_235b as tqm
from repro_torch.models import common as MC
from repro_torch.models import transformer as TT

from _torch_jax import _release_jax_programs  # noqa: F401

BF16_TOL = 2.0 ** -6
ARCHS = {"gemma3-1b": (jg, tg), "qwen3-32b": (jq, tq),
         "mistral-nemo-12b": (jm, tm)}
#: Every LM arch's config module pair (the decode tests take the dense
#: ones above; ``test_torch_train.py`` holds the MoE ones' numerics).
CONFIG_ARCHS = {**ARCHS, "qwen3-moe-235b-a22b": (jqm, tqm),
                "grok-1-314b": (jgk, tgk)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: The reference's config fields the port leaves out: ``probe_unroll``
#: unrolls the reference's scans for the TPU dry-run's cost analysis.
TRAINING_KNOBS = {"probe_unroll"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A JAX or numpy array → tensor of the same dtype (bf16 included)."""
    return convert.params({"a": a})["a"]


def _np(x) -> np.ndarray:
    """A tensor or JAX array → float32 numpy."""
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tols(dtype: str) -> dict:
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=BF16_TOL, atol=BF16_TOL)


def _pair(rng, shape, dtype: str, scale: float = 1.0):
    jdt, _ = DTYPES[dtype]
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale, jdt)
    return a, _t(a)


# --------------------------------------------------------------------- #
# configs and specs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list(CONFIG_ARCHS))
def test_config_copies_are_the_reference(arch):
    j, t = CONFIG_ARCHS[arch]
    for name in ("CONFIG", "SMOKE"):
        jc, tc = getattr(j, name), getattr(t, name)
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert {f.name for f in dataclasses.fields(jc)} - \
            {f.name for f in dataclasses.fields(tc)} == TRAINING_KNOBS
        assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16
        assert (tc.n_params(), tc.n_active_params()) == \
            (jc.n_params(), jc.n_active_params())
    if arch == "gemma3-1b":
        assert t.CONFIG.n_params() == 999_751_680


def _spec_leaves(tree):
    return {".".join(k.key for k in path): s
            for path, s in jax.tree.leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JMC.ParamSpec))}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_are_the_reference(arch, moe):
    j, t = ARCHS[arch]
    over = dict(moe_experts=4, moe_top_k=2) if moe else {}
    for name in ("CONFIG", "SMOKE"):
        jc = dataclasses.replace(getattr(j, name), **over)
        tc = dataclasses.replace(getattr(t, name), **over)
        want = _spec_leaves(JT.param_specs(jc))
        got = dict(MC._leaves(TT.param_specs(tc)))
        assert got.keys() == want.keys()
        for k, s in want.items():
            g = got[k]
            assert (g.shape, g.init, g.scale) == (s.shape, s.init, s.scale)
            assert str(g.dtype).removeprefix("torch.") == \
                jnp.dtype(s.dtype).name, k
        assert MC.count_params(TT.param_specs(tc)) == \
            JMC.count_params(JT.param_specs(jc))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_state_dict_loads_every_carried_weight(arch):
    j, t = ARCHS[arch]
    tree = JMC.init_params(JT.param_specs(j.SMOKE), jax.random.key(0))
    sd = convert.params(tree)
    assert sd["embed"].dtype == torch.bfloat16
    assert sd["final_norm"].dtype == torch.float32
    model = TT.Transformer(t.SMOKE, MC.init_params(
        TT.param_specs(t.SMOKE), torch.Generator().manual_seed(0), "cpu"))
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict({k: v for k, v in sd.items()
                               if k != "attn.wo"}, strict=True)


# --------------------------------------------------------------------- #
# numerics
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm_rope_swiglu(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 5, 4, 16), dtype)
    jg_, tg_ = _pair(rng, (16,), "float32", 0.1)
    tol = _tols(dtype)
    np.testing.assert_allclose(_np(MC.rms_norm(tx, tg_)),
                               _np(JMC.rms_norm(jx, jg_)), **tol)
    pos = rng.integers(0, 40_000, size=(2, 5)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            _np(MC.rope(tx, torch.from_numpy(pos), theta)),
            _np(JMC.rope(jx, jnp.asarray(pos), theta)), **tol)
    jh, th = _pair(rng, (2, 3, 16), dtype)
    w = [_pair(rng, s, dtype, 0.3) for s in ((16, 24), (16, 24), (24, 16))]
    np.testing.assert_allclose(
        _np(MC.swiglu(th, *(b for _, b in w))),
        _np(JMC.swiglu(jh, *(a for a, _ in w))), **tol)
    assert MC.rms_norm(tx, tg_).dtype == tx.dtype


@pytest.mark.parametrize("window", [None, 3, 2**30])
@pytest.mark.parametrize("cache_len", [0, 5, 10, 11])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention(dtype, cache_len, window):
    """cache_len 0 (all masked: the reference's uniform softmax), mid-cache,
    S - 1 and S; a local window and the global layers' 2**30."""
    rng = np.random.default_rng(2)
    S = 11
    jq_, tq_ = _pair(rng, (2, 1, 4, 16), dtype)
    jk, tk = _pair(rng, (2, S, 2, 16), dtype)
    jv, tv = _pair(rng, (2, S, 2, 16), dtype)
    got = MC.decode_attention(tq_, tk, tv, cache_len, window=window)
    want = JMC.decode_attention(jq_, jk, jv, jnp.asarray(cache_len),
                                window=window)
    assert got.dtype == tq_.dtype and got.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), **_tols(dtype))


@pytest.mark.parametrize("cache_len", [5, 6, 9])
def test_cache_write_clamps_as_dynamic_update_slice(cache_len):
    """A cache of S = 6 slots: a write at 6 or 9 lands on slot 5, as
    ``lax.dynamic_update_slice`` clamps it; attention still masks with the
    unclamped ``cache_len + 1``."""
    cfg_j = dataclasses.replace(jg.SMOKE, dtype=jnp.float32)
    cfg_t = dataclasses.replace(tg.SMOKE, dtype=torch.float32)
    tree = JMC.init_params(JT.param_specs(cfg_j), jax.random.key(4))
    model = TT.Transformer(cfg_t, MC.init_params(
        TT.param_specs(cfg_t), torch.Generator().manual_seed(0), "cpu"))
    model.load_state_dict(convert.params(tree), strict=True)
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (2, 1, cfg_j.d_model), "float32")
    jk, tk = _pair(rng, (2, 6, 1, cfg_j.d_head), "float32")
    jv, tv = _pair(rng, (2, 6, 1, cfg_j.d_head), "float32")
    before = tk.clone()
    pos = np.full((2, 1), cache_len, np.int32)
    lp_j = jax.tree.map(lambda a: a[0], tree["attn"])
    want, (wk, wv) = JT._attention(jx, lp_j, cfg_j, jnp.int32(0),
                                   jnp.asarray(pos), kv_cache=(jk, jv),
                                   cache_len=jnp.int32(cache_len))
    got, (gk, gv) = TT._attention(tx, TT._layers(model.attn)[0], cfg_t, 0,
                                  torch.from_numpy(pos), kv_cache=(tk, tv),
                                  cache_len=cache_len)
    slot = min(cache_len, 5)
    assert torch.equal(gk[:, :slot], before[:, :slot])
    assert not torch.equal(gk[:, slot], before[:, slot])
    np.testing.assert_allclose(_np(gk), _np(wk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(gv), _np(wv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# serve_step
# --------------------------------------------------------------------- #
STEPS, START = 8, 4


@pytest.mark.parametrize("short", [False, True], ids=["fits", "one-short"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_step_matches_reference(arch, dtype, short):
    """8 decode steps from a cache prefilled (seeded normals) up to
    position 4; ``one-short`` leaves the cache a slot short of the last
    write, which then clamps.  Each step feeds both sides the reference's
    greedy tokens."""
    j, t = ARCHS[arch]
    jdt, tdt = DTYPES[dtype]
    cfg_j = dataclasses.replace(j.SMOKE, dtype=jdt)
    cfg_t = dataclasses.replace(t.SMOKE, dtype=tdt)
    tree = JMC.init_params(JT.param_specs(cfg_j), jax.random.key(5))
    model = TT.Transformer(cfg_t, MC.init_params(
        TT.param_specs(cfg_t), torch.Generator().manual_seed(0), "cpu"))
    model.load_state_dict(convert.params(tree), strict=True)
    B, S = 3, START + STEPS - short
    rng = np.random.default_rng(6)
    (shape, _), _ = TT.make_kv_cache_specs(cfg_t, B, S)
    assert TT.make_kv_cache_specs(cfg_t, B, S)[0][1] == tdt
    jk, tk = _pair(rng, shape, dtype)
    jv, tv = _pair(rng, shape, dtype)
    tk, tv = tk.clone(), tv.clone()
    prefill = tk[:, :, :START].clone()
    step = jax.jit(lambda p, k, v, tok, n: JT.serve_step(p, (k, v), tok, n,
                                                         cfg_j))
    tok = rng.integers(0, cfg_j.vocab, size=(B, 1)).astype(np.int32)
    for i in range(STEPS):
        n = START + i
        jl, (jk, jv) = step(tree, jk, jv, jnp.asarray(tok), jnp.int32(n))
        with torch.no_grad():
            tl, (tk2, tv2) = TT.serve_step(model, (tk, tv),
                                           torch.from_numpy(tok), n, cfg_t)
        assert tk2 is tk and tv2 is tv and tl.dtype == torch.float32
        want, got = np.asarray(jl), tl.numpy()
        scale = np.abs(want).max()
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-4 * scale
            assert np.array_equal(got.argmax(-1), want.argmax(-1))
        else:
            assert np.abs(got - want).max() <= BF16_TOL * scale
            top2 = np.sort(want, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL * scale
            assert np.array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
        tok = want.argmax(-1)[:, None].astype(np.int32)
    assert torch.equal(tk[:, :, :START], prefill)
    cache_tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
                 else dict(rtol=BF16_TOL, atol=BF16_TOL))
    np.testing.assert_allclose(_np(tk), _np(jk), **cache_tol)
    np.testing.assert_allclose(_np(tv), _np(jv), **cache_tol)


def test_training_half_raises():
    """Nothing of the training half raises any more: the cache-free
    forward, ``loss_fn``, ``prefill_step`` and MoE decode run, finite
    (their parity is ``test_torch_train.py``'s)."""
    cfg = tg.SMOKE
    model = TT.Transformer(cfg, MC.init_params(
        TT.param_specs(cfg), torch.Generator().manual_seed(0), "cpu"))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        h, aux, caches = TT.forward(model, tokens, cfg)
        assert h.shape == (1, 4, cfg.d_model) and caches is None
        assert float(aux) == 0.0
        loss = TT.loss_fn(model, {"tokens": tokens, "labels": tokens}, cfg)
        assert bool(torch.isfinite(loss))
        assert TT.prefill_step(model, tokens, cfg).shape == (1, cfg.vocab)
    moe = dataclasses.replace(cfg, moe_experts=4, moe_top_k=2)
    model = TT.Transformer(moe, MC.init_params(
        TT.param_specs(moe), torch.Generator().manual_seed(0), "cpu"))
    (shape, dt), _ = TT.make_kv_cache_specs(moe, 1, 8)
    cache = (torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt))
    with torch.no_grad():
        logits, _ = TT.serve_step(model, cache, tokens[:, :1], 0, moe)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-32b"])
def test_out_of_range_tokens_read_the_reference_rows(arch):
    """``embed[tokens]`` in the reference wraps a negative id once, then
    clamps: V and V + 3 read row V - 1, -1 row V - 1, -V row 0 and
    -V - 1 row 0.  One float32 decode step with those ids, against the
    reference's ``serve_step`` (and against in-range ids that name the
    same rows, bit for bit on the port's side)."""
    j, t = ARCHS[arch]
    cfg_j = dataclasses.replace(j.SMOKE, dtype=jnp.float32)
    cfg_t = dataclasses.replace(t.SMOKE, dtype=torch.float32)
    tree = JMC.init_params(JT.param_specs(cfg_j), jax.random.key(9))
    model = TT.Transformer(cfg_t, MC.init_params(
        TT.param_specs(cfg_t), torch.Generator().manual_seed(0), "cpu"))
    model.load_state_dict(convert.params(tree), strict=True)
    V = cfg_t.vocab
    tok = np.array([[V], [V + 3], [-1], [-V], [-V - 1]], np.int32)
    same = np.array([[V - 1], [V - 1], [V - 1], [0], [0]], np.int32)
    (shape, _), _ = TT.make_kv_cache_specs(cfg_t, 5, 6)
    jz = jnp.zeros(shape, jnp.float32)
    want, _ = JT.serve_step(tree, (jz, jz), jnp.asarray(tok), jnp.int32(0),
                            cfg_j)
    with torch.no_grad():
        got = [TT.serve_step(model, (torch.zeros(shape), torch.zeros(shape)),
                             torch.from_numpy(ids), 0, cfg_t)[0]
               for ids in (tok, same)]
    assert torch.equal(got[0], got[1])
    want = np.asarray(want)
    assert np.abs(got[0].numpy() - want).max() <= 1e-4 * np.abs(want).max()
