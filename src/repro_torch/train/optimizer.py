"""Optimizers: AdamW (default) and Adafactor (memory-lean for the biggest
archs).

The port of ``repro/train/optimizer.py``: plain functions on trees of
tensors (nested dicts, the models' parameter trees), each returning new
params and a new state, as the reference's pytree transforms do; they
run under ``torch.no_grad()``.  The numerics follow the reference line for
line: float32 moments, the clip scale from the global norm over the
leaves in the reference's flatten order (sorted keys), updates computed in
float32 and cast back to each weight's type, the step an int32 tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tree's tensors in the reference's flatten order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(template: Any, flat: List[Any]) -> Any:
    """Rebuild ``template``'s structure from ``flat`` (in :func:`leaves`
    order)."""
    return _rebuild(template, iter(flat))


def _rebuild(t: Any, it) -> Any:
    # a module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, and its iterator would keep every
    # leaf of ``flat`` alive until the cyclic collector ran (an optimizer
    # step's old weights and moments, 20 GB for DLRM's capped tables)
    if isinstance(t, dict):
        out = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, it) for v in t)
    return next(it)


def tree_map(fn: Callable, tree: Any) -> Any:
    return unflatten(tree, [fn(x) for x in leaves(tree)])


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def _step0(tree: Any) -> torch.Tensor:
    dev = leaves(tree)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=_step0(params), mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig) -> Tuple[Any, AdamWState]:
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    sf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)

    def upd(g, m, v, p):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        del g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p2 = p.float() - cfg.lr * delta
        return p2.to(p.dtype), m2, v2

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params))]
    return unflatten(params, [o[0] for o in out]), AdamWState(
        step=step, mu=unflatten(params, [o[1] for o in out]),
        nu=unflatten(params, [o[2] for o in out]))


# --------------------------------------------------------------------- #
# Adafactor (factored second moment — O(n+m) state for [n, m] weights)
# --------------------------------------------------------------------- #
class AdafactorState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    vr: Any   # row statistics (or full v for <2D params)
    vc: Any   # col statistics (zeros for <2D params)


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-4
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0


def adafactor_init(params: Any) -> AdafactorState:
    def rows(p):
        shape = p.shape[:-1] if p.ndim >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdafactorState(step=_step0(params), vr=tree_map(rows, params),
                          vc=tree_map(cols, params))


@torch.no_grad()
def adafactor_update(grads: Any, state: AdafactorState, params: Any,
                     cfg: AdafactorConfig) -> Tuple[Any, AdafactorState]:
    step = state.step + 1
    beta = 1.0 - step.float() ** (-cfg.decay)

    def upd(g, vr, vc, p):
        # the reference's expressions, op for op; the in-place ops act
        # only on temporaries made here (an expert leaf's float32 copy is
        # gigabytes, so each one made is one fewer at the peak)
        g = g.float()
        g2 = torch.square(g).add_(cfg.eps)
        if p.ndim >= 2:
            vr2 = beta * vr + (1 - beta) * g2.mean(-1)
            vc2 = beta * vc + (1 - beta) * g2.mean(-2)
            del g2
            denom = (vr2[..., :, None] * vc2[..., None, :]).div_(
                torch.clamp(vr2.mean(-1)[..., None, None], min=cfg.eps))
            u = denom.clamp_(min=cfg.eps).rsqrt_().mul_(g)
        else:
            vr2 = beta * vr + (1 - beta) * g2
            vc2 = vc
            u = g * torch.rsqrt(torch.clamp(vr2, min=cfg.eps))
        del g
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u.div_(torch.clamp(rms / cfg.clip_threshold, min=1.0)).mul_(cfg.lr)
        return torch.sub(p.float(), u).to(p.dtype), vr2, vc2

    out = [upd(g, vr, vc, p) for g, vr, vc, p in zip(
        leaves(grads), leaves(state.vr), leaves(state.vc), leaves(params))]
    return unflatten(params, [o[0] for o in out]), AdafactorState(
        step=step, vr=unflatten(params, [o[1] for o in out]),
        vc=unflatten(params, [o[2] for o in out]))


OPTIMIZERS: Dict[str, Tuple[Callable, Callable, Any]] = {
    "adamw": (adamw_init, adamw_update, AdamWConfig()),
    "adafactor": (adafactor_init, adafactor_update, AdafactorConfig()),
}
