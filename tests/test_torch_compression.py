"""Port parity of gradient compression (``distributed/compression.py``):
int8 quantization and top-k sparsification with error feedback bit for
bit with the reference on the CPU, and ``hierarchical_psum`` on 4 gloo
CPU ranks (one spawn for the module) against a flat ``all_reduce`` and
against the reference's ``hierarchical_psum`` under shard_map on 4 host
devices (a subprocess), with the work counter's collective bytes."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.distributed import compression as TC
from repro_torch.launch import mesh

from _torch_jax import _release_jax_programs  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
#: (pods, data) meshes of the 4 ranks
MESHES = ((2, 2), (1, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(rng):
    """A tree of float32 and bfloat16 leaves, as numpy float32 (the bf16
    leaf's values are bf16-representable)."""
    b = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    return {"w": rng.normal(size=(64,)).astype(np.float32),
            "layer": {"k": rng.normal(size=(5, 9)).astype(np.float32),
                      "b": b.to(torch.bfloat16).float().numpy()}}


def _tree(g, lib, key=""):
    """numpy tree → the port's (torch) or the reference's (jnp) tree; the
    leaf ``b`` in bfloat16."""
    if isinstance(g, dict):
        return {k: _tree(v, lib, k) for k, v in g.items()}
    if lib == "torch":
        t = torch.from_numpy(g)
        return t.to(torch.bfloat16) if key == "b" else t
    return jnp.asarray(g, jnp.bfloat16 if key == "b" else jnp.float32)


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view({1: np.int8, 4: np.int32}[a.dtype.itemsize])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_int8_error_feedback_bit_for_bit():
    """30 steps as the reference's own test runs them, fresh gradients each
    step: q, scale and residual bits equal the reference's."""
    rng = np.random.default_rng(0)
    t_ef = TC.ef_init(_tree(_grads(rng), "torch"))
    j_ef = JC.ef_init(_tree(_grads(rng), "jax"))
    for step in range(30):
        g = _grads(rng)
        tq, ts, t_ef = TC.compress_int8_ef(_tree(g, "torch"), t_ef)
        jq, js, j_ef = JC.compress_int8_ef(_tree(g, "jax"), j_ef)
        for got, want in zip(_leaves((tq, ts, t_ef.residual)),
                             _leaves((jq, js, j_ef.residual))):
            assert got.dtype == getattr(torch, str(want.dtype)), step
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"step {step}")
    x = torch.from_numpy(rng.normal(size=(33,)).astype(np.float32))
    q, s = TC.quantize_int8(x)
    np.testing.assert_array_equal(
        _bits(TC.dequantize_int8(q, s)),
        _bits(JC.dequantize_int8(*JC.quantize_int8(jnp.asarray(x.numpy())))))


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.5])
def test_topk_error_feedback_on_tie_free_inputs(k_frac):
    """Five steps on float32 leaves whose |g + residual| has no ties
    (checked): indices, kept values and residuals equal the reference's
    (``top_k`` and ``torch.topk`` may order tied magnitudes differently)."""
    rng = np.random.default_rng(1)

    def grads():
        g = _grads(rng)
        del g["layer"]["b"]       # bfloat16 values tie in magnitude
        return g

    t_ef = TC.ef_init(_tree(grads(), "torch"))
    j_ef = JC.ef_init(_tree(grads(), "jax"))
    for step in range(5):
        g = grads()
        for leaf, r in zip(_leaves(g), _leaves(t_ef.residual)):
            x = np.abs(leaf + r.numpy())
            assert np.unique(x).size == x.size
        t_out, t_ef = TC.topk_ef(_tree(g, "torch"), t_ef, k_frac)
        j_out, j_ef = JC.topk_ef(_tree(g, "jax"), j_ef, k_frac)
        for got, want in zip(_leaves((t_out, t_ef.residual)),
                             _leaves((j_out, j_ef.residual))):
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"step {step}")


def _psum_inputs():
    rng = np.random.default_rng(2)
    return dict(
        ints=rng.integers(-1000, 1000, (4, 6, 3)).astype(np.float32),
        normal=rng.normal(size=(4, 10, 7)).astype(np.float32),
        # size 15: the reference pads by shape[0] (5 → 8, 18 entries) and
        # rejects it at |data| 4; at |data| 2 it pads to 16 and runs
        odd=rng.integers(-50, 50, (4, 5, 3)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    """Every input on both meshes, on 4 gloo CPU ranks spawned once:
    {(mesh, name): stacked outputs}."""
    xs = _psum_inputs()
    outs = mesh.spawn_pes(TC.psum_rank, 4, args=(list(MESHES),
                                                  list(xs.values())),
                          device="cpu")
    keys = [(m, name) for m in MESHES for name in xs]
    return dict(zip(keys, outs))


@pytest.mark.parametrize("pods,data", MESHES)
@pytest.mark.parametrize("name", ["ints", "normal", "odd"])
def test_hierarchical_psum_equals_flat_all_reduce(psum, pods, data, name):
    """Every rank gets the sum over the 4 ranks: exact on integer-valued
    float32, within float32 rounding (1e-6 of the sum of |x|) on normal
    data; the odd shape is one the reference rejects at |data| 4."""
    x = _psum_inputs()[name]
    out = psum[((pods, data), name)]
    assert out["hier"].shape == x.shape
    if name == "normal":
        tol = 1e-6 * np.abs(x).sum(0)
        assert (np.abs(out["hier"] - out["flat"]) <= tol).all()
        assert (np.abs(out["hier"] - x.sum(0)) <= tol).all()
    else:
        np.testing.assert_array_equal(out["hier"], out["flat"])
        np.testing.assert_array_equal(out["hier"][0], x.sum(0))


def test_counter_counts_collective_output_bytes(psum):
    """The work counter on each rank sees the three collectives of
    ``hierarchical_psum``, each by its output's bytes (hlo.py's
    convention): the all_gather on the 2-rank data group gathers the
    padded tensor (18 float32 entries of a 6 x 3 input), the
    reduce-scatter and the pod all_reduce hold one shard."""
    coll = [json.loads(c) for c in psum[((2, 2), "ints")]["coll"]]
    assert coll == [{"reduce-scatter": 36, "all-reduce": 36,
                     "all-gather": 72}] * 4
    coll = json.loads(psum[((1, 4), "odd")]["coll"][0])
    assert coll == {"reduce-scatter": 16, "all-reduce": 16,
                    "all-gather": 64}


REFERENCE_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.distributed import shard_map_compat
    from repro.distributed.compression import hierarchical_psum

    xs = np.load(sys.argv[1])
    out = {}
    for pods, data in ((2, 2), (1, 4)):
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(pods, data),
                    ("pod", "data"))
        spec = P(("pod", "data"))
        fn = jax.jit(shard_map_compat(
            lambda x: hierarchical_psum(x[0])[None], mesh, (spec,), spec))
        for name in xs.files:
            key = f"{pods}x{data}_{name}"
            try:
                out[key] = np.asarray(fn(xs[name]))
            except Exception as e:
                out[key + "_error"] = np.asarray(type(e).__name__)
    np.savez(sys.argv[2], **out)
""")


def test_hierarchical_psum_matches_reference_shard_map(psum, tmp_path):
    """The reference under shard_map on 4 host devices (a subprocess):
    equal wherever it runs (bit for bit on integer-valued data, within
    float32 rounding on normal data, whose 4-way reduce-scatter may add
    in another order); it rejects the odd shape at |data| 4 and the port
    sums it."""
    xs = _psum_inputs()
    np.savez(tmp_path / "xs.npz", **xs)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", REFERENCE_PSUM,
                          str(tmp_path / "xs.npz"), str(tmp_path / "ref.npz")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    assert "1x4_odd_error" in ref.files and "2x2_odd" in ref.files
    for (pods, data), name in psum:
        key = f"{pods}x{data}_{name}"
        if key + "_error" in ref.files:
            continue
        got = psum[((pods, data), name)]["hier"]
        if name == "normal":
            np.testing.assert_allclose(got, ref[key], rtol=0,
                                       atol=1e-6 * np.abs(xs[name]).sum())
        else:
            np.testing.assert_array_equal(got, ref[key], err_msg=key)


def test_pod_data_groups_need_the_whole_world(tmp_path):
    """A mesh that is not the whole group is refused (one gloo rank, in
    this process)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=(tmp_path / "rv").as_uri(),
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 6 ranks"):
            TC.pod_data_groups(3, 2)
        pod_group, data_group = TC.pod_data_groups(1, 1)
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(TC.hierarchical_psum(
            x, pod_group=pod_group, data_group=data_group), x)
    finally:
        dist.destroy_process_group()
