"""Port parity of the admission gate and the output audit:
``repro_torch.core.validate`` gives the same repaired graph, report and
reason code as ``repro.core.validate`` on the cases of
``tests/test_validate.py``."""

import numpy as np
import pytest

from repro.core import validate as JV
from repro.core.graph import Graph as JGraph
from repro_torch.core import validate as TV
from repro_torch.core.graph import Graph as TGraph


def _csr(n, pairs, w=None):
    """CSR arrays from explicit DIRECTED (src, dst) pairs — no symmetrizing
    or dedup, so the validator sees genuinely malformed edge lists."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(pairs[:, 0], minlength=n), out=indptr[1:])
    weights = (np.arange(n, dtype=np.int32) + 1) if w is None \
        else np.asarray(w)
    return indptr, pairs[:, 1].astype(np.int32), weights


def _path(n, w):
    """A canonical path 0-1-...-(n-1)."""
    pairs = [(i, i + 1) for i in range(n - 1)]
    return _csr(n, pairs + [(b, a) for a, b in pairs], w)


TWO = (np.array([0, 1, 2]), np.array([1, 0], np.int32))

CASES = {
    "canonical": _path(4, np.array([5, 1, 5, 1], np.int32)),
    "self_loops": _csr(3, [(0, 0), (0, 1), (1, 0), (2, 2)]),
    "dup_and_asymmetric": _csr(3, [(0, 1), (0, 1), (1, 0), (1, 2)]),
    "unsorted_rows": (np.array([0, 2, 3, 4]), np.array([2, 1, 0, 0],
                                                       np.int32),
                      np.array([1, 2, 3], np.int32)),
    "float_weights": (*TWO, np.array([3.0, 4.0])),
    "int64_weights": (*TWO, np.array([3, 4], np.int64)),
    "nan_weight": (*TWO, np.array([np.nan, 1.0])),
    "inf_weight": (*TWO, np.array([np.inf, 1.0])),
    "non_integral": (*TWO, np.array([1.5, 2.0])),
    "negative": (*TWO, np.array([-1, 2], np.int64)),
    "overflow": (*TWO, np.array([2**40, 2], np.int64)),
    "bool_weights": (*TWO, np.array([True, False])),
    "index_out_of_range": (np.array([0, 1, 2]), np.array([5, 0], np.int32),
                           np.array([1, 2], np.int32)),
    "float_indices": (np.array([0, 1, 2]), np.array([1.0, 0.0]),
                      np.array([1, 2], np.int32)),
    "indptr_wrong_length": (np.array([0, 2]), np.array([1, 0], np.int32),
                            np.array([1, 2], np.int32)),
    "indptr_nonzero_start": (np.array([1, 1, 2]), np.array([1, 0], np.int32),
                             np.array([1, 2], np.int32)),
    "indptr_not_monotone": (np.array([0, 2, 1]), np.array([1, 0], np.int32),
                            np.array([1, 2], np.int32)),
    "indptr_past_end": (np.array([0, 1, 5]), np.array([1, 0], np.int32),
                        np.array([1, 2], np.int32)),
    "float_indptr": (np.array([0.0, 1.0, 2.0]), np.array([1, 0], np.int32),
                     np.array([1, 2], np.int32)),
    "two_d_weights": (*TWO, np.array([[1, 2]], np.int32)),
    "empty": (np.zeros(1, np.int64), np.zeros(0, np.int32),
              np.zeros(0, np.int32)),
    "isolated": (np.zeros(4, np.int64), np.zeros(0, np.int32),
                 np.array([1, 2, 3], np.int32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_canonicalize_matches_reference(case):
    indptr, indices, weights = CASES[case]
    jg = JGraph(indptr=indptr, indices=indices, weights=weights)
    tg = TGraph(indptr=indptr, indices=indices, weights=weights)
    jfixed, jrep = JV.canonicalize(jg)
    tfixed, trep = TV.canonicalize(tg)
    assert tuple(trep) == tuple(jrep), case
    assert (tfixed is None) == (jfixed is None)
    assert (tfixed is tg) == (jfixed is jg)   # identity keeps cache hits
    if tfixed is not None:
        for f in ("indptr", "indices", "weights"):
            a, b = getattr(tfixed, f), getattr(jfixed, f)
            assert a.dtype == b.dtype, (case, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{case}: {f}")
        tv = TV.validate_instance(tg)
        assert np.array_equal(tv.indices, tfixed.indices)
    else:
        with pytest.raises(TV.InvalidInstance) as ei:
            TV.validate_instance(tg)
        assert ei.value.reason == trep.reason


GRAPH = _path(4, np.array([5, 1, 5, 1], np.int32))
EDGE = _csr(3, [(0, 1), (1, 0)], np.array([2, 3, 4], np.int32))


@pytest.mark.parametrize("graph,members,weight", [
    (GRAPH, [True, False, True, False], 10),
    (GRAPH, [True, False, True, False], None),
    (GRAPH, [True, False, True, False], 11),
    (EDGE, [True, True, False], None),
    (EDGE, [False, True, True], 99),
    (EDGE, [True, False], None),
    (EDGE, [1, 0, 1], None),
    (EDGE, [False, False, False], 0),
])
def test_verify_result_matches_reference(graph, members, weight):
    m = np.asarray(members)
    got = TV.verify_result(TGraph(*graph), m, weight)
    want = JV.verify_result(JGraph(*graph), m, weight)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("w", [[0, 5, 2**31 - 1], [-1, 3], [2**31, 0], []])
def test_residual_weights_matches_reference(w):
    w = np.asarray(w, np.int64)
    try:
        want = JV.residual_weights(w, where="test")
    except JV.InvalidInstance as e:
        with pytest.raises(TV.InvalidInstance) as ei:
            TV.residual_weights(w, where="test")
        assert (ei.value.reason, ei.value.detail) == (e.reason, e.detail)
    else:
        got = TV.residual_weights(w, where="test")
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_reason_codes_match_reference():
    names = [n for n in dir(JV) if n.startswith(("REASON_", "REPAIR_"))]
    assert names
    for n in names:
        assert getattr(TV, n) == getattr(JV, n), n
