"""Port parity of the CLI: ``repro_torch.launch.mwis_run --device
cpu`` prints the same stats lines as ``repro.launch.mwis_run`` for the same
seed (instance, partition, rounds, kernel ratios, offset, weight, |I|),
with the wall times stripped."""

import re
import sys

import pytest
import torch

from repro.launch import mwis_run as jrun
from repro_torch.launch import mwis_run as trun

from _torch_jax import _release_jax_programs  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so torch's pool does not fight
    JAX's (and the other test workers') threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(text: str) -> list:
    text = re.sub(r" ?time=[0-9.]+s", "", text)
    text = re.sub(r" \([0-9.]+s\)", "", text)
    return [ln for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("algo,family,n,p,mode,schedule,jb,tb", [
    ("reduce", "rgg", 400, 4, "async", "cheap-fused", "pallas", "cuda"),
    ("greedy", "rhg", 400, 2, "sync", "cheap", "jnp", "torch"),
    ("rg", "gnm", 300, 4, "sync", "edges-only", "blocked", "cuda"),
    ("rnp", "rgg", 250, 2, "async", "edges-only", "blocked", "cuda"),
])
def test_cli_prints_reference_stats(capsys, monkeypatch, algo, family, n, p,
                                    mode, schedule, jb, tb):
    common = ["--family", family, "--n", str(n), "--p", str(p), "--algo",
              algo, "--mode", mode, "--schedule", schedule, "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["mwis_run", *common, "--backend", jb])
    jrun.main()
    want = _stats(capsys.readouterr().out)
    trun.main([*common, "--backend", tb, "--device", "cpu"])
    got = _stats(capsys.readouterr().out)
    assert got == want
    assert len(got) == 3
