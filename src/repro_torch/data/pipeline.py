"""Deterministic synthetic data pipelines, indexable by step.

A copy of ``repro/data/pipeline.py`` (numpy only): the port imports nothing
of the reference, so it keeps its own.  The batches are bit for bit the
reference's for the same (spec, step, host_slice).

Restart-safety contract: a batch is a pure function of (seed, step), so
resuming at step k replays nothing and skips nothing — no data-loader
state needs checkpointing.  Sharded loading: each host materializes only
its slice of the global batch (`host_slice`), the standard multi-host
input pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMBatchSpec:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0


def lm_batch(spec: LMBatchSpec, step: int,
             host_slice: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    lo, hi = host_slice or (0, spec.global_batch)
    rng = np.random.default_rng(
        np.random.SeedSequence([spec.seed, step, lo])
    )
    b = hi - lo
    # Zipf-ish marginal over the vocab + shifted-label LM convention
    tokens = (rng.pareto(1.2, size=(b, spec.seq_len + 1)) * 17).astype(np.int64)
    tokens = np.minimum(tokens, spec.vocab - 1).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@dataclasses.dataclass(frozen=True)
class DLRMBatchSpec:
    global_batch: int
    n_dense: int
    n_sparse: int
    vocabs: Tuple[int, ...]
    seed: int = 0


def dlrm_batch(spec: DLRMBatchSpec, step: int,
               host_slice: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    lo, hi = host_slice or (0, spec.global_batch)
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, step, lo]))
    b = hi - lo
    dense = rng.normal(size=(b, spec.n_dense)).astype(np.float32)
    sparse = np.stack(
        [rng.integers(0, v, size=b) for v in spec.vocabs[: spec.n_sparse]],
        axis=1,
    ).astype(np.int32)
    labels = rng.integers(0, 2, size=b).astype(np.int32)
    return {"dense": dense, "sparse": sparse, "labels": labels}
