"""Shared model substrate: param specs, norms, RoPE, SwiGLU, decode attention.

The port of ``repro/models/common.py``'s serving half.  A model's weights
are a nested dict of tensors, each described by a :class:`ParamSpec`
(shape, torch dtype, initializer, scale); :func:`init_params` materializes
them on a device from an explicit ``torch.Generator``, and
:func:`register_tree` hangs such a tree on an ``nn.Module`` so its
``state_dict`` keys are the reference's tree paths joined with ``.``.

The numerics follow the reference line for line, casts included: norms,
RoPE and attention compute in float32 and cast back to the input's type.
The reference's GSPMD partition specs and sharding hints have no meaning
on one card and are not carried.  The training half (chunked and flash
attention with its backward, the chunked loss) waits for the training
slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"   # normal | zeros | ones
    scale: float = 0.02


ParamTree = Dict[str, Any]  # nested dict of ParamSpec / tensors


def _leaves(tree: ParamTree, prefix: str = ""):
    """(dotted path, leaf) in the reference's flatten order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def init_params(specs: ParamTree, generator: torch.Generator,
                device: torch.device | str) -> ParamTree:
    """Materialize ``specs`` on ``device``: normal leaves draw float32 from
    ``generator`` (which must live on ``device``), scale, then cast, as the
    reference does; ``zeros`` / ``ones`` leaves are constant."""
    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(s.scale).to(s.dtype)

    def walk(tree: ParamTree) -> ParamTree:
        return {k: walk(tree[k]) if isinstance(tree[k], dict)
                else one(tree[k]) for k in sorted(tree)}

    return walk(specs)


def count_params(specs: ParamTree) -> int:
    return sum(int(math.prod(s.shape)) for _, s in _leaves(specs))


def register_tree(module: nn.Module, tree: ParamTree) -> None:
    """Hang a nested dict of tensors on ``module``: a dict becomes a child
    module, a tensor a parameter (no gradient: these are served weights).
    ``state_dict`` keys are then the tree's paths joined with ``.``."""
    for name, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            register_tree(child, v)
            module.add_module(name, child)
        else:
            module.register_parameter(
                name, nn.Parameter(v, requires_grad=False))


# --------------------------------------------------------------------- #
# numerics
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs  # [..., T, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("btd,df->btf", x, w_gate.to(x.dtype))
    u = torch.einsum("btd,df->btf", x, w_up.to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("btf,fd->btd", h, w_down.to(x.dtype))


# --------------------------------------------------------------------- #
# attention — decode against a KV cache
# --------------------------------------------------------------------- #
NEG_INF = -1e30


def decode_attention(
    q: torch.Tensor,        # [B, 1, H, Dh]
    k_cache: torch.Tensor,  # [B, S, Hkv, Dh]
    v_cache: torch.Tensor,  # [B, S, Hkv, Dh]
    cache_len: int,         # number of valid cache positions
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token attention against a full KV cache (serve_step hot path).
    The mask bounds are integers (a global layer's window of 2**30 makes
    ``cache_len - window`` negative), never floats."""
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qh = (q.reshape(B, Hkv, rep, Dh) * scale).float()
    s = torch.einsum("bgrd,bsgd->bgrs", qh, k_cache.float())
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < cache_len
    if window is not None:
        mask &= pos[None, :] >= cache_len - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)
