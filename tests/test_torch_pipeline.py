"""Port parity of the synthetic data pipelines: ``repro_torch.data.pipeline``
(a numpy copy) gives the reference's batches bit for bit, over seeds,
steps and host slices."""

import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as jp
from repro.models.dlrm import MLPERF_VOCABS
from repro_torch.data import pipeline as tp

SLICES = [None, (0, 3), (3, 8), (5, 6)]


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("host_slice", SLICES)
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (5, 3)])
def test_lm_batch_bit_for_bit(seed, step, host_slice):
    args = dict(global_batch=8, seq_len=33, vocab=128, seed=seed)
    _same(tp.lm_batch(tp.LMBatchSpec(**args), step, host_slice),
          jp.lm_batch(jp.LMBatchSpec(**args), step, host_slice))


@pytest.mark.parametrize("host_slice", SLICES)
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 11), (3, 2)])
@pytest.mark.parametrize("vocabs", [MLPERF_VOCABS, (64, 3, 1000) * 9])
def test_dlrm_batch_bit_for_bit(seed, step, host_slice, vocabs):
    args = dict(global_batch=8, n_dense=13, n_sparse=26, vocabs=vocabs,
                seed=seed)
    _same(tp.dlrm_batch(tp.DLRMBatchSpec(**args), step, host_slice),
          jp.dlrm_batch(jp.DLRMBatchSpec(**args), step, host_slice))


def test_specs_are_the_reference_fields():
    for t, j in ((tp.LMBatchSpec, jp.LMBatchSpec),
                 (tp.DLRMBatchSpec, jp.DLRMBatchSpec)):
        assert ([(f.name, f.default) for f in dataclasses.fields(t)]
                == [(f.name, f.default) for f in dataclasses.fields(j)])
