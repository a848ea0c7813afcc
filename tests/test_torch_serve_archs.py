"""Port parity of the serving CLI's model archs:
``repro_torch.launch.serve --arch {dlrm-mlperf,gemma3-1b,qwen3-32b,
mistral-nemo-12b} --device cpu`` against ``repro.launch.serve``.

Both CLIs are given the same weights: each one's ``init_params`` is
patched to return the reference's tree (``jax.random.key(0)``, as the
reference CLI draws it), carried to the port by ``convert.params``.  So the
comparison holds the wiring of each path (the SMOKE config picked, the
batches, the zeroed cache of ``tokens + 8`` positions, the start at token
0, the greedy feedback), not only the printed lines.

- DLRM: the weights are scaled as ``test_torch_dlrm.py``'s unit-logits
  case (x8), so the mean CTRs lie away from 0.5; each request's must be
  within 1e-4 of the reference CLI's printed value.
- LM: the reference CLI's logits are recorded at every step.  Tolerance
  as ``test_torch_lm.py``'s bfloat16 one: ``BF16_TOL`` = 2^-6 of the
  largest logit.  Each batch row's greedy tokens must equal the
  reference's as long as every step's top-2 gap exceeds twice that (a
  closer call may rightly go either way, and then the row's later tokens
  follow another path); such rows' last logits must be within the
  tolerance.

Without ``--device cpu`` and with no GPU the CLI refuses to run."""

import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import dlrm_mlperf as jdlrm
from repro.configs import gemma3_1b, mistral_nemo_12b, qwen3_32b
from repro.launch import serve as jserve
from repro.models import common as JMC
from repro.models import dlrm as JD
from repro.models import transformer as JT
from repro_torch import convert, kernels
from repro_torch.launch import serve as tserve
from repro_torch.models import common as TMC

from _torch_jax import _release_jax_programs  # noqa: F401

BF16_TOL = 2.0 ** -6
#: test_torch_dlrm.py's unit-logits scale for the SMOKE DLRM
DLRM_UNIT = 8.0
#: The reference's SMOKE config of each LM arch.
LM_SMOKES = {"gemma3-1b": gemma3_1b.SMOKE, "qwen3-32b": qwen3_32b.SMOKE,
             "mistral-nemo-12b": mistral_nemo_12b.SMOKE}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REQUEST = re.compile(r"request (\d+): batch=(\d+) mean_ctr=([0-9.]+) "
                     r"lat=[0-9.]+ms")
DECODED = re.compile(r"decoded (\d+) tokens x batch (\d+) in [0-9.]+s "
                     r"\([0-9.]+ tok/s, incl\. ")


def _reference(capsys, monkeypatch, argv) -> list:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    return capsys.readouterr().out.splitlines()


def _same_weights(monkeypatch, tree) -> None:
    """Both CLIs' ``init_params`` return ``tree`` (the port's by way of
    ``convert.params``, on the device the CLI asks for)."""
    monkeypatch.setattr(JMC, "init_params", lambda specs, key: tree)
    monkeypatch.setattr(
        TMC, "init_params",
        lambda specs, gen, device: TMC.nest(convert.params(tree, device)))


def test_arches_are_the_reference():
    assert tserve.ARCHES == jserve.ARCHES


def test_dlrm_cli_prints_the_reference_lines(capsys, monkeypatch):
    tree = JMC.init_params(JD.param_specs(jdlrm.SMOKE), jax.random.key(0))
    _same_weights(monkeypatch,
                  jax.tree.map(lambda a: a * DLRM_UNIT, tree))
    argv = ["--arch", "dlrm-mlperf", "--requests", "5", "--batch", "8"]
    want = _reference(capsys, monkeypatch, argv)
    kernels.reset_launch_counts()
    # --seed moves only the port's weights (patched here), not the batches
    out = tserve.serve_dlrm(tserve.build_parser().parse_args(
        [*argv, "--device", "cpu", "--seed", "3"]))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 6
    for r, (g, w) in enumerate(zip(got[:5], want[:5])):
        gm, wm = REQUEST.fullmatch(g), REQUEST.fullmatch(w)
        assert gm and wm, (g, w)
        assert gm.groups()[:2] == wm.groups()[:2] == (str(r), "8")
        assert gm[3] == f"{out['mean_ctr'][r]:.4f}"
        # the reference's value is printed to 4 places: hold the port's
        # unrounded one against it
        assert abs(out["mean_ctr"][r] - float(wm[3])) <= 1e-4, (g, w)
    # the scaled weights make the check bite: the requests' CTRs spread
    # out and leave 0.5, so other weights or batches would show
    ctr = np.asarray(out["mean_ctr"])
    assert np.ptp(ctr) > 0.1 and np.abs(ctr - 0.5).max() > 0.1, ctr
    assert re.fullmatch(r"p50=[0-9.]+ms p99=[0-9.]+ms", got[5])
    assert len(out["latencies_ms"]) == len(out["mean_ctr"]) == 5
    assert all(kernels.launch_count(k) == 0 for k in kernels.KERNELS)


def _recording_serve_step(monkeypatch) -> list:
    """Patch the reference's ``serve_step`` so that the reference CLI's
    jitted decode hands each step's logits back to the host."""
    seen, orig = [], JT.serve_step

    def rec(params, cache, tok, pos, cfg):
        logits, cache = orig(params, cache, tok, pos, cfg)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), logits,
                           ordered=True)
        return logits, cache

    monkeypatch.setattr(JT, "serve_step", rec)
    return seen


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-32b",
                                  "mistral-nemo-12b"])
def test_lm_cli_decodes_and_prints_the_reference_line(capsys, monkeypatch,
                                                      arch):
    jcfg = LM_SMOKES[arch]
    _same_weights(monkeypatch, JMC.init_params(JT.param_specs(jcfg),
                                               jax.random.key(0)))
    seen = _recording_serve_step(monkeypatch)
    T, B = 6, 3
    argv = ["--arch", arch, "--tokens", str(T), "--batch", str(B)]
    want = _reference(capsys, monkeypatch, argv)
    jax.effects_barrier()
    out = tserve.serve_lm(tserve.build_parser().parse_args(
        [*argv, "--device", "cpu", "--seed", "3"]))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 1
    gm, wm = DECODED.match(got[0]), DECODED.match(want[0])
    assert gm and wm and gm.groups() == wm.groups() == (str(T), str(B))

    assert len(seen) == T and seen[0].shape == (B, jcfg.vocab)
    ref = np.stack(seen, 1)                          # [B, T, V]
    scale = np.abs(ref).max()
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 2 * BF16_TOL * scale).all(1)
    tokens = out["tokens"].numpy()
    assert tokens.shape == (B, T)
    for b in range(B):
        for t in range(T):
            if top2[b, t, 1] - top2[b, t, 0] <= 2 * BF16_TOL * scale:
                break
            assert tokens[b, t] == ref[b, t].argmax(), (b, t)
    assert clear.any(), "no row decoded clear of a near-tie: nothing held"
    last = out["logits"].numpy()
    assert np.abs(last[clear] - ref[clear, -1]).max(initial=0.0) <= \
        BF16_TOL * scale


def test_lm_cli_returns_finite_logits():
    out = tserve.serve_lm(tserve.build_parser().parse_args(
        ["--arch", "gemma3-1b", "--tokens", "3", "--batch", "2",
         "--device", "cpu"]))
    assert out["logits"].shape == (2, 128)
    assert bool(torch.isfinite(out["logits"]).all())


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "gemma3-1b"])
def test_cli_refuses_without_a_gpu(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", arch, "--requests", "2", "--tokens", "2"])
