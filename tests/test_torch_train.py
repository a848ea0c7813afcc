"""Port parity of LM training: ``repro_torch.train.optimizer``, the
training half of ``repro_torch.models.{common,transformer}`` and the
training supervisor, against ``repro.train.optimizer``,
``repro.models.{common,transformer}`` and ``repro.distributed.fault`` on
the same numpy inputs, with the reference's weights (``MC.init_params``)
carried across by ``convert.params``.

Tolerances, stated once:
- optimizers: one update from the same grads, state and params within
  float32 rounding (rtol 2e-6 on float32 leaves and moments); a bfloat16
  weight within one bfloat16 ulp (its float32 update may land on either
  side of a rounding boundary);
- attention: float32 outputs within 1e-5 (rtol and atol), gradients
  within 1e-5 of each gradient's largest magnitude (the tiles' sums run in
  another order; measured ≤ 6e-7);
- ``loss_fn``: float32 loss within 1e-5 relative, each weight's gradient
  within 1e-5 of its largest magnitude; bfloat16 loss within 2^-8
  relative (one bfloat16 ulp: both sides compute in float32 and round
  where the reference rounds), each gradient within ``BF16_GRAD_TOL`` =
  2^-5 of its largest magnitude (eight ulps: the backward rounds every
  activation gradient to bfloat16 in each layer, and the leaf's own
  rounding adds one; measured ≤ 2^-5.9).  The MoE archs' bfloat16
  cases route every token to every expert (``moe_top_k = moe_experts``):
  top-k is a discontinuous choice, and a one-ulp difference in a bfloat16
  activation (the two sides' matmuls sum in other orders) flips a
  near-tie between two experts, which moves a whole token's gradient
  from one expert to another (seen: 0.3-0.4 of a leaf's largest
  magnitude on 3 of 4 seeds).  The float32 cases hold top-k, the stable
  sort and the capacity drops exactly;
- ``prefill_step``: logits within 1e-4 (float32) / ``BF16_TOL`` = 2^-6
  (bfloat16, as ``test_torch_lm.py``) of the largest logit;
- the MoE dispatch: kept set and slots exactly equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as jg
from repro.configs import grok1_314b as jgk
from repro.configs import qwen3_moe_235b as jq
from repro.distributed.checkpoint import CheckpointManager as JCheckpoint
from repro.models import common as JMC
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import gemma3_1b as tg
from repro_torch.configs import grok1_314b as tgk
from repro_torch.configs import qwen3_moe_235b as tq
from repro_torch.configs.smoke_runners import lm_smoke
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import StragglerMonitor, TrainSupervisor
from repro_torch.launch import train as ttrain
from repro_torch.models import common as MC
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as opt
from repro_torch.train.step import loss_and_grads

from _torch_jax import _release_jax_programs  # noqa: F401

BF16_TOL = 2.0 ** -6
BF16_GRAD_TOL = 2.0 ** -5
ARCHS = {"gemma3-1b": (jg, tg), "qwen3-moe-235b-a22b": (jq, tq),
         "grok-1-314b": (jgk, tgk)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree) -> dict:
    """A reference tree → {dotted path: leaf}."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree.leaves_with_path(tree)}


def _close_to_max(got, want, tol: float, what: str = "") -> None:
    """max |got - want| within ``tol`` of want's largest magnitude."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), what


# --------------------------------------------------------------------- #
# optimizers
# --------------------------------------------------------------------- #
def _opt_inputs(seed: int):
    """Params, grads and a mid-run state of the reference's optimizer:
    float32 and bfloat16 leaves, 1-D, 2-D and 4-D ([L, E, D, F],
    Adafactor's factored stats over the last two axes)."""
    rng = np.random.default_rng(seed)
    shapes = {"bias": ((7,), jnp.float32), "w": ((6, 5), jnp.bfloat16),
              "moe": {"w_up": ((2, 3, 4, 5), jnp.bfloat16),
                      "norm": ((2, 4), jnp.float32)}}

    def draw(spec, scale):
        return jnp.asarray(rng.normal(size=spec[0]) * scale, spec[1])

    is_spec = lambda x: isinstance(x, tuple) and isinstance(x[0], tuple)
    params = jax.tree.map(lambda s: draw(s, 0.5), shapes, is_leaf=is_spec)
    grads = jax.tree.map(lambda s: draw(s, 3.0), shapes, is_leaf=is_spec)
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    """Two updates from the reference's state after one of its own: the
    port is fed the reference's grads (a step-1 Adam update is ±lr for
    any gradient far above eps, so independent backward passes would test
    the signs of near-zero grads, not the optimizer)."""
    jinit, jupd, _ = jopt.OPTIMIZERS[name]
    tinit, tupd, _ = opt.OPTIMIZERS[name]
    jcfg = (jopt.AdamWConfig(lr=0.01, grad_clip=0.5) if name == "adamw"
            else jopt.AdafactorConfig(lr=0.01))
    tcfg = (opt.AdamWConfig(lr=0.01, grad_clip=0.5) if name == "adamw"
            else opt.AdafactorConfig(lr=0.01))
    params, grads = _opt_inputs(1)
    _, state = jupd(grads, jinit(params), params, jcfg)
    params2, grads2 = _opt_inputs(2)
    want_p, want_s = jupd(grads2, state, params2, jcfg)
    tp = MC.nest(convert.params(params2))
    got_p, got_s = tupd(MC.nest(convert.params(grads2)),
                        convert.opt_state(state), tp, tcfg)
    assert got_s.step.dtype == torch.int32 and int(got_s.step) == 2
    assert type(got_s) is type(tinit(tp))
    for k, w in _flat(want_p).items():
        g = dict(MC._leaves(got_p))[k]
        assert g.dtype == _t(w).dtype, k
        if g.dtype == torch.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(_np(w)))) - 7)
            assert (np.abs(_np(g) - _np(w)) <= ulp).all(), k
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=2e-6,
                                       atol=1e-7, err_msg=k)
    for f in got_s._fields[1:]:
        got = dict(MC._leaves(getattr(got_s, f)))
        for k, w in _flat(getattr(want_s, f)).items():
            assert got[k].dtype == torch.float32, (f, k)
            np.testing.assert_allclose(_np(got[k]), _np(w), rtol=2e-6,
                                       atol=1e-12, err_msg=f"{f}.{k}")


def test_adamw_and_adafactor_reduce_quadratic_loss():
    """``tests/test_misc.py``'s bar: both drive sum((w - 3)^2) below 5 %
    of its start in 60 steps."""
    def loss(p):
        return torch.sum((p["w"] - 3.0) ** 2)

    for name in ("adamw", "adafactor"):
        init, update, _ = opt.OPTIMIZERS[name]
        cfg = (opt.AdamWConfig(lr=0.1) if name == "adamw"
               else opt.AdafactorConfig(lr=0.3))
        params = {"w": torch.zeros((4, 4))}
        state = init(params)
        l0 = float(loss(params))
        for _ in range(60):
            w = params["w"].clone().requires_grad_()
            loss({"w": w}).backward()
            params, state = update({"w": w.grad}, state, params, cfg)
        assert float(loss(params)) < 0.05 * l0, name


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
#: tests/test_models.py's flash cases: B, T, H, Hkv, Dh, chunk, window
FLASH_CASES = [(2, 37, 4, 2, 8, 16, None), (1, 64, 4, 1, 16, 16, 9),
               (2, 33, 2, 2, 8, 8, None), (1, 100, 8, 4, 4, 32, 25)]


def _qkv(rng, B, T, H, Hkv, Dh):
    return tuple(rng.normal(size=s).astype(np.float32) for s in
                 ((B, T, H, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh)))


@pytest.mark.parametrize("B,T,H,Hkv,Dh,chunk,window", FLASH_CASES)
def test_flash_attention_fwd_and_grads(B, T, H, Hkv, Dh, chunk, window):
    """Forward and the (q, k, v) gradients of sum(out²) against the
    reference's ``flash_attention`` under ``jax.grad``."""
    qkv = _qkv(np.random.default_rng(0), B, T, H, Hkv, Dh)
    w = None if window is None else jnp.asarray(window)
    jqkv = [jnp.asarray(a) for a in qkv]
    want = JMC.flash_attention(*jqkv, w, chunk=chunk)
    wgrads = jax.grad(
        lambda *a: (JMC.flash_attention(*a, w, chunk=chunk) ** 2).sum(),
        argnums=(0, 1, 2))(*jqkv)
    tqkv = [torch.from_numpy(a).requires_grad_() for a in qkv]
    got = MC.flash_attention(*tqkv, window, chunk=chunk)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    for t, wg, name in zip(tqkv, wgrads, "qkv"):
        _close_to_max(t.grad, wg, 1e-5, f"d{name}")


def test_flash_saves_only_its_residuals():
    """The flash call keeps exactly (q, k, v, out, lse) for its backward,
    counted through ``saved_tensors_hooks``: the backward is the
    Function's own, not autograd through the tiled loop."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in
               _qkv(np.random.default_rng(1), 2, 40, 4, 2, 8))
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = MC.flash_attention(q, k, v, 9, chunk=16)
    assert len(saved) == 5
    assert all(a is b for a, b in zip(saved[:3], (q, k, v)))
    assert torch.equal(saved[3], out)
    assert saved[4].shape == (2, 40, 2, 2) and saved[4].dtype == torch.float32
    out.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 7, 0), (False, None, 0), (True, None, 5)])
def test_chunked_attention_matches_reference(causal, window, q_offset):
    rng = np.random.default_rng(2)
    qkv = _qkv(rng, 2, 40, 4, 2, 8)
    want = JMC.chunked_attention(*(jnp.asarray(a) for a in qkv),
                                 causal=causal, window=window,
                                 q_offset=q_offset, chunk=16)
    got = MC.chunked_attention(*(torch.from_numpy(a) for a in qkv),
                               causal=causal, window=window,
                               q_offset=q_offset, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("labels", ["in-range", "V-and-minus-1"])
def test_chunked_xent_matches_reference(labels):
    """Value and the (h, emb) gradients; a label V gives the reference's
    NaN loss (``take_along_axis`` fills) with finite gradients (the
    gather's transpose drops it), a label -1 wraps to V - 1."""
    rng = np.random.default_rng(3)
    B, T, D, V = 2, 16, 8, 50
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    emb = rng.normal(size=(V, D)).astype(np.float32)
    lab = rng.integers(0, V, size=(B, T)).astype(np.int32)
    if labels != "in-range":
        lab[0, 3], lab[1, 5], lab[1, 6] = V, -1, -V
    jl, (jdh, jde) = jax.value_and_grad(
        lambda a, b: JMC.chunked_xent(a, b, jnp.asarray(lab), n_chunks=4),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    th, te = (torch.from_numpy(a).requires_grad_() for a in (h, emb))
    tl = MC.chunked_xent(th, te, torch.from_numpy(lab), n_chunks=4)
    tl.backward()
    if labels == "in-range":
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    else:
        assert np.isnan(float(jl)) and np.isnan(float(tl.detach()))
        lab[0, 3] = 0
        fin = MC.chunked_xent(torch.from_numpy(h), torch.from_numpy(emb),
                              torch.from_numpy(lab), n_chunks=4)
        wrapped = JMC.chunked_xent(jnp.asarray(h), jnp.asarray(emb),
                                   jnp.asarray(lab), n_chunks=4)
        np.testing.assert_allclose(float(fin), float(wrapped), rtol=1e-5)
    _close_to_max(th.grad, jdh, 1e-5, "dh")
    _close_to_max(te.grad, jde, 1e-5, "demb")


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def _configs(arch: str, dtype: str, **over):
    j, t = ARCHS[arch]
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(j.SMOKE, dtype=jdt, **over),
            dataclasses.replace(t.SMOKE, dtype=tdt, **over))


def _batch(cfg, seed: int, B: int = 2, T: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
            for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def _reference_tree(arch: str, dtype: str):
    cj, _ = _configs(arch, dtype)
    return JMC.init_params(JT.param_specs(cj), jax.random.key(7))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_fn_value_and_grads_match_reference(arch, dtype):
    """gemma3-1b SMOKE (local:global windows), qwen3-moe and grok-1 SMOKE
    (the MoE FFN and its aux loss): ``loss_fn`` and the gradient of every
    weight against the reference's ``jax.value_and_grad``."""
    j, _ = ARCHS[arch]
    every = (dict(moe_top_k=j.SMOKE.moe_experts)
             if dtype == "bfloat16" and j.SMOKE.moe_experts else {})
    cj, ct = _configs(arch, dtype, **every)
    tree = _reference_tree(arch, dtype)
    b = _batch(cj, 4)
    jl, jg_ = jax.jit(jax.value_and_grad(
        lambda p, bb: JT.loss_fn(p, bb, cj)))(
            tree, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg_ = loss_and_grads(MC.nest(convert.params(tree)),
                             {k: torch.from_numpy(v) for k, v in b.items()},
                             ct)
    got = dict(MC._leaves(tg_))
    want = _flat(jg_)
    assert got.keys() == want.keys()
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        tol = 1e-5
    else:
        np.testing.assert_allclose(float(tl), float(jl), rtol=2.0 ** -8)
        tol = BF16_GRAD_TOL
    for k, w in want.items():
        assert got[k].dtype == _t(w).dtype, k
        _close_to_max(got[k], w, tol, k)


def test_remat_changes_no_bit():
    """``remat`` (each layer under ``torch.utils.checkpoint``) recomputes
    the same values: loss and gradients equal bit for bit."""
    tree = _reference_tree("qwen3-moe-235b-a22b", "float32")
    _, ct = _configs("qwen3-moe-235b-a22b", "float32")
    b = {k: torch.from_numpy(v) for k, v in _batch(ct, 5).items()}
    outs = [loss_and_grads(MC.nest(convert.params(tree)), b,
                           dataclasses.replace(ct, remat=r))
            for r in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    for (k, a), (_, c) in zip(MC._leaves(outs[0][1]),
                              MC._leaves(outs[1][1])):
        assert torch.equal(a, c), k


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_step_matches_reference(arch, dtype):
    cj, ct = _configs(arch, dtype)
    tree = _reference_tree(arch, dtype)
    tok = _batch(cj, 6, T=24)["tokens"]
    want = np.asarray(jax.jit(lambda p, t: JT.prefill_step(p, t, cj))(
        tree, jnp.asarray(tok)))
    model = TT.Transformer(ct, MC.nest(convert.params(tree)))
    with torch.no_grad():
        got = TT.prefill_step(model, torch.from_numpy(tok), ct)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def test_moe_drops_at_capacity_exactly_as_the_reference():
    """qwen3-moe SMOKE's layer 0 at ``capacity_factor=0.5``: cap 32 of the
    128 assignments a layer's 8 experts take on 2 x 32 tokens, so the
    busiest experts overflow.  The kept set and the slots equal the
    reference's dispatch (``repro/models/transformer.py:209-217`` on the
    reference's own top-k), which a sort that is not stable would break;
    the output matches the reference's ``_moe_ffn``."""
    cj, ct = _configs("qwen3-moe-235b-a22b", "float32", capacity_factor=0.5)
    tree = _reference_tree("qwen3-moe-235b-a22b", "float32")
    x = np.random.default_rng(8).normal(size=(2, 32, cj.d_model)) \
        .astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], tree["ffn"])
    want, waux = JT._moe_ffn(jnp.asarray(x), lp_j, cj)
    # the reference's routing and dispatch, on its own arrays
    hf = JMC.rms_norm(jnp.asarray(x), lp_j["norm"]).reshape(-1, cj.d_model)
    probs = jax.nn.softmax(hf @ lp_j["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, cj.moe_top_k)
    NA, E = idx.size, cj.moe_experts
    cap = int(max(1, round(NA / E * cj.capacity_factor)))
    flat_e = idx.reshape(NA)
    order = jnp.argsort(flat_e)
    starts = jnp.searchsorted(flat_e[order], jnp.arange(E))
    rank = jnp.zeros(NA, jnp.int32).at[order].set(
        jnp.arange(NA) - starts[flat_e[order]])
    wkeep = np.asarray(rank < cap)
    wslot = np.where(wkeep, np.asarray(flat_e * cap + rank), E * cap)

    keep, slot = TT._dispatch(torch.from_numpy(np.array(flat_e)).long(),
                              E, cap)
    assert 0 < wkeep.sum() < NA
    assert np.array_equal(keep.numpy(), wkeep)
    assert np.array_equal(slot.numpy(), wslot)
    lp_t = TT._layers(TT.Transformer(ct, MC.nest(convert.params(tree)))
                      .ffn)[0]
    with torch.no_grad():
        got, aux = TT._moe_ffn(torch.from_numpy(x), lp_t, ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


# --------------------------------------------------------------------- #
# supervisor, checkpoints, smoke
# --------------------------------------------------------------------- #
def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.int32)}}


def test_supervisor_restart_resumes(tmp_path):
    """``tests/test_checkpoint.py``'s bar: a 5-step run saves every 2
    steps and at its end; a restart for 7 steps replays nothing."""
    cm = CheckpointManager(str(tmp_path), async_write=False)
    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"a": state["a"] + 1, "nested": state["nested"]}

    out = TrainSupervisor(cm, save_every=2).run(
        _tree(), step_fn, 5, state_template=_tree())
    assert calls == [0, 1, 2, 3, 4] and float(out["a"][0, 0]) == 5.0
    assert cm.list_steps()[-1] == 4
    calls.clear()
    sup = TrainSupervisor(cm, save_every=2)
    out = sup.run(_tree(), step_fn, 7, state_template=_tree())
    assert calls == [5, 6] and float(out["a"][0, 0]) == 7.0
    assert sup.events[0] == ("restored", 4)
    assert torch.is_tensor(out["nested"]["b"])
    assert out["nested"]["b"].dtype == torch.int32


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(alpha=0.5, factor=2.0)
    assert not m.observe(1.0)
    assert not m.observe(1.1)
    assert m.observe(5.0)
    assert m.flagged == 1


def test_bf16_tree_and_optimizer_state_round_trip(tmp_path):
    """A bfloat16 LM tree and its AdamW state survive save / restore bit
    for bit; the manifest names the dtype and hashes the saved bits."""
    _, ct = _configs("gemma3-1b", "bfloat16")
    params = MC.init_params(TT.param_specs(ct),
                            torch.Generator().manual_seed(0), "cpu")
    ostate = opt.adamw_init(params)
    ostate = ostate._replace(mu=opt.tree_map(lambda m: m + 0.5, ostate.mu),
                             step=ostate.step + 3)
    state = {"params": params, "opt": ostate}
    cm = CheckpointManager(str(tmp_path), async_write=True)
    cm.save(9, state)
    meta = cm.manifest()["leaves"]
    assert meta["params.embed"]["dtype"] == "bfloat16"
    assert meta["opt.step"]["dtype"] == "int32"
    got = cm.restore(state)
    assert type(got["opt"]) is opt.AdamWState
    want = _pairs(state)
    assert _pairs(got).keys() == want.keys()
    for k, a in _pairs(got).items():
        assert a.dtype == want[k].dtype and torch.equal(a, want[k]), k
    # a numpy template leaf gets the saved bits
    bits = cm.restore({"params": {"embed": np.zeros(1)}})
    assert bits["params"]["embed"].dtype == np.uint16
    assert np.array_equal(bits["params"]["embed"],
                          params["embed"].view(torch.int16).numpy()
                          .view(np.uint16))
    # the reference's manager reads the port's manifest
    jback = JCheckpoint(str(tmp_path)).manifest()
    assert jback["leaves"]["opt.mu.embed"]["dtype"] == "float32"


def _pairs(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_pairs(v, f"{prefix}{k}."))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_pairs(getattr(tree, k), f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = tree
    return out


@pytest.mark.parametrize("arch", list(ttrain.SMOKES))
def test_arch_smoke(arch):
    """``tests/test_models.py``'s bar for each LM arch's SMOKE config: one
    AdamW train step (finite loss and weights) and one decode step."""
    lm_smoke(ttrain.SMOKES[arch], device="cpu")
