"""Port parity of the training CLI: ``repro_torch.launch.train --arch
gemma3-1b --device cpu`` against ``repro.launch.train``.

Both CLIs are given the same weights: each one's ``init_params`` is
patched to return the reference's tree (``jax.random.key(0)``, as the
reference CLI draws it), carried to the port by ``convert.params``.  The
batches are ``lm_batch`` by step on both sides, so the comparison holds
the wiring (the SMOKE config with ``loss_chunks=2``, AdamW at lr 3e-4, the
supervisor's cadence) and not only the printed lines.

Tolerance: every printed loss within 2^-9 relative of the reference CLI's.
The SMOKE config trains in bfloat16: step 0's loss is the forward's
(within 2^-8, as ``test_torch_train.py``; a mean over 512 tokens), and
after ten AdamW steps a weight may sit one bfloat16 ulp apart (an update
of ±lr lands either side of a rounding boundary).  Measured: within
2e-5 relative at steps 0, 10, 20 and 30.

A second port run for 16 steps on the same ``--ckpt`` restores step 10
and runs steps 11-15 only; without ``--device cpu`` and with no GPU the
CLI refuses to run.
"""

import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b
from repro.launch import train as jtrain
from repro.models import common as JMC
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.launch import train as ttrain
from repro_torch.models import common as TMC

from _torch_jax import _release_jax_programs  # noqa: F401

LOSS = re.compile(r"step (\d+): loss=([0-9.]+)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _losses(lines) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in map(LOSS.match, lines) if m}


def test_smokes_are_the_reference_archs():
    assert set(ttrain.SMOKES) == {"gemma3-1b", "qwen3-32b",
                                  "qwen3-moe-235b-a22b", "grok-1-314b",
                                  "mistral-nemo-12b"}
    for name, cfg in ttrain.SMOKES.items():
        assert cfg.name == name


def test_train_cli_prints_the_reference_losses_and_resumes(
        capsys, monkeypatch, tmp_path):
    tree = JMC.init_params(JT.param_specs(gemma3_1b.SMOKE),
                           jax.random.key(0))
    monkeypatch.setattr(JMC, "init_params", lambda specs, key: tree)
    monkeypatch.setattr(
        TMC, "init_params",
        lambda specs, gen, device: TMC.nest(convert.params(tree, device)))
    argv = ["--arch", "gemma3-1b", "--steps", "11"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt",
                                      str(tmp_path / "ref")])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    ck = str(tmp_path / "port")
    out = ttrain.main([*argv, "--device", "cpu", "--ckpt", ck])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]          # training gemma3-1b (reduced): ...
    wl, gl = _losses(want), _losses(got)
    assert sorted(gl) == sorted(wl) == [0, 10]
    for step, loss in wl.items():
        assert np.isfinite(gl[step])
        assert abs(gl[step] - loss) <= 2.0 ** -9 * loss, (step, gl, wl)
        assert abs(out["losses"][step] - gl[step]) <= 5e-5
    assert not [e for e in out["events"] if e[0] == "restored"]
    assert int(out["state"]["opt"].step) == 11

    again = ttrain.main(["--arch", "gemma3-1b", "--steps", "16",
                         "--device", "cpu", "--ckpt", ck])
    lines = capsys.readouterr().out.splitlines()
    assert again["events"][0] == ("restored", 10)
    assert again["losses"] == {} and not _losses(lines)
    assert "('restored', 10)" in lines[-1]
    assert int(again["state"]["opt"].step) == 16
    assert again["state"]["params"]["embed"].dtype == torch.bfloat16


def test_train_cli_refuses_other_arches_and_a_missing_gpu(capsys):
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "mwis", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "gemma3-1b" in err and "qwen3-moe-235b-a22b" in err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--steps", "1"])
