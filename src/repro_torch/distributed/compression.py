"""Gradient compression for cross-pod data parallelism.

The port of ``repro/distributed/compression.py``.  At 2+ pods the
gradient all-reduce crosses the slow inter-pod links; the standard
mitigations implemented here:

  * int8 quantization with per-tensor scale + **error feedback** (the
    quantization residual is carried into the next step, preserving
    convergence — Seide et al. / EF-SGD),
  * top-k sparsification with error feedback (bandwidth ∝ k),
  * :func:`hierarchical_psum`: reduce-scatter intra-pod, all-reduce only
    the 1/|data| shard across pods, all-gather intra-pod, over
    ``torch.distributed`` subgroups (:func:`pod_data_groups`).

The transforms are plain functions on tensor trees (nested dicts and
lists, walked in ``train/optimizer.py``'s order: dict keys sorted), with
the reference's float32 arithmetic op for op, so q, scale and residual
are bit for bit the reference's.
"""

from __future__ import annotations

import json
from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.exchange import _wire
from repro_torch.train.optimizer import leaves, tree_map, unflatten


class EFState(NamedTuple):
    residual: Any  # same tree as grads, float32 leaves


def ef_init(grads_like: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 scalar): scale = max(|x|max, 1e-12) / 127,
    q = clip(round-half-even(x / scale), -127, 127)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_int8_ef(grads: Any, ef: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (quantized tree, scales tree, new EF state)."""
    qs, ss, rs = [], [], []
    for g, r in zip(leaves(grads), leaves(ef.residual)):
        x = g.to(torch.float32) + r
        q, s = quantize_int8(x)
        qs.append(q)
        ss.append(s)
        rs.append(x - dequantize_int8(q, s))
    return (unflatten(grads, qs), unflatten(grads, ss),
            EFState(residual=unflatten(grads, rs)))


def topk_ef(grads: Any, ef: EFState, k_frac: float = 0.01):
    """Top-k magnitude sparsification with error feedback: per leaf
    ``(idx int32 [k], kept float32 [k])`` in descending |x| order, and the
    new residual.  Ties in |x| may be ordered differently from
    ``jax.lax.top_k`` (lower index first); on tie-free inputs the result
    is the reference's."""
    outs, rs = [], []
    for g, r in zip(leaves(grads), leaves(ef.residual)):
        x = (g.to(torch.float32) + r).reshape(-1)
        k = max(1, int(x.shape[0] * k_frac))
        idx = torch.topk(x.abs(), k).indices
        kept = x[idx]
        sparse = torch.zeros_like(x)
        sparse[idx] = kept
        outs.append((idx.to(torch.int32), kept))
        rs.append((x - sparse).reshape(g.shape))
    return unflatten(grads, outs), EFState(residual=unflatten(grads, rs))


def pod_data_groups(pods: int, data: int):
    """This rank's ``(pod_group, data_group)`` on a (pod, data) mesh of
    ``pods * data`` ranks, rank = pod * data + d: the pod group joins the
    ranks of one data index across pods, the data group the ranks of one
    pod.  Every rank creates every group, in the same order, as
    ``dist.new_group`` requires."""
    if dist.get_world_size() != pods * data:
        raise ValueError(f"a {pods} x {data} mesh needs {pods * data} ranks, "
                         f"the group has {dist.get_world_size()}")
    rank = dist.get_rank()
    pod_groups = [dist.new_group([p * data + d for p in range(pods)])
                  for d in range(data)]
    data_groups = [dist.new_group([p * data + d for d in range(data)])
                   for p in range(pods)]
    return pod_groups[rank % data], data_groups[rank // data]


def hierarchical_psum(x: torch.Tensor, *, pod_group, data_group
                      ) -> torch.Tensor:
    """Sum of ``x`` over every rank of the (pod, data) mesh: reduce-scatter
    within ``data_group`` → ``all_reduce`` of the shard across
    ``pod_group`` → ``all_gather`` within ``data_group``; the slow
    inter-pod link carries 1/|data| of the bytes.

    The flat tensor is padded to a multiple of |data|.  The reference pads
    by ``x.shape[0]`` instead, so its reshape raises unless size + pad is a
    multiple of |data| (e.g. shape (5, 3) with |data| 4); wherever it runs
    the two pads are equal and so are the results.  gloo is a host
    transport: on a gloo group the tensor is copied to the host for the
    collectives (gloo has all three for CPU tensors) and the sum copied
    back to ``x``'s device."""
    n = dist.get_world_size(data_group)
    flat = _wire(x, data_group).reshape(-1)
    pad = (-flat.shape[0]) % n
    xp = torch.cat([flat, flat.new_zeros(pad)])
    shard = xp.new_empty(xp.shape[0] // n)
    # ``reduce_scatter_tensor``: older torch has no ``reduce_scatter_single``
    dist.reduce_scatter_tensor(shard, xp, group=data_group)
    dist.all_reduce(shard, group=pod_group)
    full = xp.new_empty(xp.shape[0])
    dist.all_gather_into_tensor(full, shard, group=data_group)
    return full[:x.numel()].reshape(x.shape).to(x.device)


def psum_rank(rank: int, world: int, device: torch.device, meshes, xs):
    """Rank entry (``launch.mesh.spawn_pes``) of the hierarchical_psum
    checks: for each (pods, data) of ``meshes`` (every rank builds every
    mesh's groups, in order) and each array of ``xs`` (numpy [world, ...],
    row ``rank`` this rank's), on ``device``: the hierarchical sum
    (``hier``), the flat ``all_reduce`` of the default group (``flat``)
    and the collective bytes a work counter saw in the hierarchical call
    (``coll``, JSON)."""
    from repro_torch.analysis.count import WorkCounter

    out = []
    for pods, data in meshes:
        pod_group, data_group = pod_data_groups(pods, data)
        for x in xs:
            t = torch.from_numpy(x[rank]).to(device)
            with WorkCounter() as wc:
                hier = hierarchical_psum(t, pod_group=pod_group,
                                         data_group=data_group)
            flat = _wire(t, None).clone()
            dist.all_reduce(flat)
            out.append(dict(hier=hier.cpu().numpy(), flat=flat.cpu().numpy(),
                            device=str(hier.device),
                            coll=json.dumps(wc.summary()["collectives"])))
    return out
