"""Port parity of the smoke runners (``repro_torch.configs.smoke_runners``)
against ``repro.configs.smoke_runners``, and the port's bar of
``tests/test_models.py::test_arch_smoke``: one train step for every model
arch config, on the CPU.

The reference's smoke runners build their batches inline, so the batches
are held against the same draws made with the reference's own generator
and sampler; the step is held against the reference's loss, gradients
and ``adamw_update`` from the same converted weights.

Tolerances: the loss within 1e-5 relative; each updated weight within
1e-6 (atol) of the reference's, except where the reference's gradient is
within rounding of 0 (below 1e-6 of the model's largest gradient): a
first AdamW step moves a weight by lr · g / (|g| + eps), so a gradient
that rounds to the other side of 0 moves it up to 2 · lr apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet_cfg as jdim
from repro.configs import dlrm_mlperf as jdlrm
from repro.configs import equiformer_v2_cfg as jeq
from repro.configs import gatedgcn_cfg as jgg
from repro.configs import graphsage_reddit as jgs
from repro.graphs import generators as jgen
from repro.graphs import sampler as jsampler
from repro.models import common as JMC
from repro.models import dlrm as JD
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import dimenet_cfg as tdim
from repro_torch.configs import dlrm_mlperf as tdlrm
from repro_torch.configs import equiformer_v2_cfg as teq
from repro_torch.configs import gatedgcn_cfg as tgg
from repro_torch.configs import gemma3_1b, grok1_314b, mistral_nemo_12b
from repro_torch.configs import graphsage_reddit as tgs
from repro_torch.configs import qwen3_32b, qwen3_moe_235b
from repro_torch.configs import smoke_runners as SR
from repro_torch.models import common as MC

from _torch_jax import _release_jax_programs  # noqa: F401

#: arch: (reference config module, port config module, molecular, sampled)
GNNS = {
    "graphsage-reddit": (jgs, tgs, False, True),
    "gatedgcn": (jgg, tgg, False, False),
    "dimenet": (jdim, tdim, True, False),
    "equiformer-v2": (jeq, teq, True, False),
}
#: The model arch configs (the reference's registry less ``mwis``, whose
#: smoke the port's solver tests cover).
ARCH_CONFIGS = {
    "dlrm-mlperf": tdlrm, "gemma3-1b": gemma3_1b, "qwen3-32b": qwen3_32b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b, "grok-1-314b": grok1_314b,
    "mistral-nemo-12b": mistral_nemo_12b,
    **{k: v[1] for k, v in GNNS.items()},
}
LR = jopt.AdamWConfig().lr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_gnn_batch(cfg, molecular: bool, sampled: bool) -> dict:
    """The reference smoke runner's draws (its ``gnn_smoke`` body) with the
    reference's own generator and sampler."""
    rng = np.random.default_rng(0)
    g = jgen.rgg2d(120, avg_deg=6, seed=0)
    if sampled:
        sub = jsampler.sample_fanout(g, np.arange(8), cfg.sample_sizes,
                                     rng=rng, pad_nodes=160, pad_edges=400)
        row, col, n = sub.row, sub.col, sub.n_sub
    else:
        row, col, n = (g.edge_sources().astype(np.int32),
                       g.indices.astype(np.int32), g.n)
    b = dict(node_feat=np.asarray(jnp.asarray(
                 rng.normal(size=(n, getattr(cfg, "d_feat", 16))),
                 jnp.float32)),
             row=row, col=col,
             labels=rng.integers(0, 4, size=n).astype(np.int32),
             label_mask=np.ones((n,), np.float32))
    if molecular:
        b.update(triplets=jsampler.build_triplets(row, col, n,
                                                  budget=4 * row.shape[0]),
                 pos=np.asarray(jnp.asarray(rng.normal(size=(n, 3)),
                                            jnp.float32)),
                 batch_id=np.zeros((n,), np.int32),
                 energy=np.zeros((1,), np.float32), n_graphs=1)
    return b


@pytest.mark.parametrize("arch", list(GNNS))
def test_gnn_smoke_batch_matches_reference(arch):
    jmod, tmod, molecular, sampled = GNNS[arch]
    got = SR.gnn_smoke_batch(tmod.SMOKE, molecular=molecular,
                             sampled=sampled)
    want = _reference_gnn_batch(jmod.SMOKE, molecular, sampled)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k


def _reference_step(loss_fn, tree, batch):
    """The reference's jitted smoke step body: loss, grads, one AdamW
    update at the default config."""
    static = {k: v for k, v in batch.items() if not isinstance(v, np.ndarray)}
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}

    @jax.jit
    def step(p, b):
        loss, grads = jax.value_and_grad(
            lambda q: loss_fn(q, dict(b, **static)))(p)
        p2, _ = jopt.adamw_update(grads, jopt.adamw_init(p), p,
                                  jopt.AdamWConfig())
        return loss, grads, p2

    return step(tree, arrays)


def _flat(tree) -> dict:
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree.leaves_with_path(tree)}


def _check_step(got_loss, got_params, want_loss, want_grads, want_params):
    assert abs(got_loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = {k: v.detach().numpy() for k, v in MC._leaves(got_params)}
    want, grads = _flat(want_params), _flat(want_grads)
    assert set(got) == set(want)
    tiny = 1e-6 * max(np.abs(g).max() for g in grads.values())
    for k, w in want.items():
        atol = np.where(np.abs(grads[k]) <= tiny, 2 * LR, 1e-6)
        assert (np.abs(got[k] - w) <= atol).all(), k


@pytest.mark.parametrize("arch", list(GNNS))
def test_gnn_smoke_step_matches_reference(arch):
    """``gnn_smoke`` from the reference's weights: its loss and updated
    weights against the reference smoke runner's step."""
    jmod, tmod, molecular, sampled = GNNS[arch]
    tree = JMC.init_params(jmod.module.param_specs(jmod.SMOKE),
                           jax.random.key(0))
    loss, params = SR.gnn_smoke(tmod.module, tmod.SMOKE, molecular=molecular,
                                sampled=sampled, device="cpu",
                                params=MC.nest(convert.params(tree)))
    batch = _reference_gnn_batch(jmod.SMOKE, molecular, sampled)
    _check_step(loss, params, *_reference_step(
        lambda p, b: jmod.module.loss_fn(p, b, jmod.SMOKE), tree, batch))


def test_dlrm_smoke_step_matches_reference():
    """``dlrm_smoke`` from the reference's weights (x 8: logits of order
    one): its loss and updated weights against the reference's step on
    the smoke runner's draws."""
    cfg = jdlrm.SMOKE
    tree = jax.tree.map(lambda a: a * 8.0, JMC.init_params(
        JD.param_specs(cfg), jax.random.key(0)))
    loss, params = SR.dlrm_smoke(tdlrm.SMOKE, device="cpu",
                                 params=MC.nest(convert.params(tree)))
    batch, _ = SR.dlrm_smoke_batches(tdlrm.SMOKE)
    rng = np.random.default_rng(0)
    want = dict(dense=np.asarray(jnp.asarray(rng.normal(size=(16, 13)),
                                             jnp.float32)),
                sparse=np.asarray(jnp.asarray(
                    rng.integers(0, 3, size=(16, 26)), jnp.int32)),
                labels=np.asarray(jnp.asarray(rng.integers(0, 2, size=16),
                                              jnp.int32)))
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
    _check_step(loss, params, *_reference_step(
        lambda p, b: JD.loss_fn(p, b, cfg), tree, batch))


@pytest.mark.parametrize("arch", list(ARCH_CONFIGS))
def test_arch_smoke(arch):
    """``tests/test_models.py``'s bar for each model arch's SMOKE config:
    the config's ``smoke`` on the CPU (one AdamW train step with a finite
    loss and weights; DLRM's serving and retrieval steps, the LMs' decode
    step)."""
    ARCH_CONFIGS[arch].smoke(device="cpu")


def test_smoke_needs_a_card_unless_asked_for_the_cpu():
    """The smoke entry points default to the card and raise without one
    (the port never moves to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdlrm.smoke()
