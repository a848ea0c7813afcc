"""Shared model substrate: param specs, norms, RoPE, SwiGLU, attention, loss.

The port of ``repro/models/common.py``.  A model's weights
are a nested dict of tensors, each described by a :class:`ParamSpec`
(shape, torch dtype, initializer, scale); :func:`init_params` materializes
them on a device from an explicit ``torch.Generator`` (:func:`abstract_params`
as meta tensors), and
:func:`register_tree` hangs such a tree on an ``nn.Module`` so its
``state_dict`` keys are the reference's tree paths joined with ``.``.

The numerics follow the reference line for line, casts included: norms,
RoPE and attention compute in float32 and cast back to the input's type.

Sharding (the dry-run's sharded count): each :class:`ParamSpec` carries
the reference's partition spec (``pspec``: one entry a dim, an axis name,
a tuple of names or ``None``), :func:`sanitize_pspec` drops the axes a dim
does not divide, :func:`param_shardings` gives each leaf's DTensor
placements on a ``DeviceMesh`` and :func:`abstract_dtensor` lays a leaf
out as a DTensor whose local shard is a meta tensor.  :func:`shard_hint`
is the reference's activation constraint: it redistributes a DTensor to
the sanitised spec once :func:`set_hint_mesh` has installed a mesh, and
is the identity otherwise (every run on one device).  The few ops whose
DTensor operands DTensor's own rules do not serve (:func:`einsum`,
:func:`flash_attention`, the loss's gold logit, :func:`lookup`, ...) hand
them to ``analysis.sharded``.

The training half: :func:`chunked_attention` (the tiled online-softmax
oracle), :func:`flash_attention` (the same tiling under a
``torch.autograd.Function`` whose backward is the reference's
FlashAttention-2 recompute: it saves only q, k, v, out and lse) and
:func:`chunked_xent` (the tied LM head's loss a chunk at a time, each chunk
recomputed in the backward).  The reference's ``lax.scan`` loops are
Python loops over the same tiles, in the same order; its ``unroll``
knobs only shape a scan for the TPU dry-run's cost analysis and are not
carried.  Like the reference, every tile is computed, masked ones
included (block skipping is left to a fused kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import is_dtensor


#: A partition spec: one entry a dim (an axis name, a tuple of axis names
#: or None); missing trailing entries are None.  ``()`` is replicated,
#: the reference's ``P()``.
PSpec = Tuple[Any, ...]


def canonical_pspec(pspec: PSpec) -> PSpec:
    """``pspec`` as ``jax.sharding.PartitionSpec`` holds it: an entry of
    one axis is the name itself, one of none is ``None``."""
    return tuple(
        (e[0] if len(e) == 1 else None if not e else e)
        if isinstance(e, tuple) else e for e in pspec)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    pspec: PSpec = ()
    init: str = "normal"   # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        object.__setattr__(self, "pspec", canonical_pspec(self.pspec))


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


def abstract_params(specs: ParamTree) -> ParamTree:
    """``specs`` as meta tensors of each leaf's shape and dtype, in the
    tree :func:`init_params` returns: the weights of the dry-run's
    abstract count, which hold no memory (the reference's
    ``abstract_params``)."""
    def walk(tree: ParamTree) -> ParamTree:
        return {k: walk(tree[k]) if isinstance(tree[k], dict)
                else torch.empty(tree[k].shape, dtype=tree[k].dtype,
                                 device="meta") for k in sorted(tree)}

    return walk(specs)


def count_params(specs: ParamTree) -> int:
    return sum(int(math.prod(s.shape)) for _, s in _leaves(specs))


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def sanitize_pspec(shape: Tuple[int, ...], pspec: PSpec, mesh) -> PSpec:
    """Drop mesh axes from dims they don't divide (jit in_shardings require
    exact divisibility, unlike with_sharding_constraint)."""
    sizes = _axis_sizes(mesh)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    out = []
    for dim, ent in zip(shape, entries[: len(shape)]):
        if ent is None:
            out.append(None)
            continue
        axes = ent if isinstance(ent, tuple) else (ent,)
        axes = tuple(a for a in axes if a in sizes)
        # greedily keep the prefix of axes whose product divides the dim
        kept = []
        prod = 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


def placements(shape: Tuple[int, ...], pspec: PSpec, mesh) -> tuple:
    """DTensor placements on ``mesh`` of a tensor of ``shape`` laid out by
    ``pspec`` (sanitised): ``Shard(d)`` on every mesh dim whose axis names
    tensor dim d, ``Replicate()`` on the others.

    A dim sharded over several axes is cut in mesh-dim order, where the
    spec orders them as written: DLRM's tables, ``("model", "data")`` on
    rows, put rows model-major, DTensor's ``[Shard(0), Shard(0)]``
    data-major.  Each device holds a block of the same size and bytes
    either way, which is all a count reads."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ent in enumerate(sanitize_pspec(tuple(shape), pspec, mesh)):
        for a in (() if ent is None else ent if isinstance(ent, tuple)
                  else (ent,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(specs: ParamTree, mesh) -> ParamTree:
    """Each leaf's DTensor placements on ``mesh`` (:func:`placements` of
    its sanitised spec), in the specs' tree."""
    def walk(tree: ParamTree) -> ParamTree:
        return {k: walk(tree[k]) if isinstance(tree[k], dict)
                else placements(tree[k].shape, tree[k].pspec, mesh)
                for k in sorted(tree)}

    return walk(specs)


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (no tensor made:
    under a work counter an allocation would count)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def local_shape(shape: Tuple[int, ...], places, mesh) -> Tuple[int, ...]:
    """One device's shard of ``shape`` under ``places`` (every sharded dim
    divides evenly: the placements come from a sanitised spec)."""
    out = list(shape)
    for m, p in enumerate(places):
        if p.is_shard():
            out[p.dim] //= mesh.size(m)
    return tuple(out)


def abstract_dtensor(shape: Tuple[int, ...], dtype: torch.dtype, places,
                     mesh) -> torch.Tensor:
    """A DTensor of global ``shape`` laid out by ``places`` on ``mesh``
    whose local shard is a meta tensor: an input of the sharded count,
    which holds no memory."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(shape, places, mesh), dtype=dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def block_slices(shape: Tuple[int, ...], places, mesh) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` laid out by ``places``
    on ``mesh``, one slice a dim (a dim cut by several mesh dims is cut
    in mesh-dim order, as DTensor cuts it; every cut divides)."""
    coord = mesh.get_coordinate()
    lo, n = [0] * len(shape), list(shape)
    for m, p in enumerate(places):
        if p.is_shard():
            n[p.dim] //= mesh.size(m)
            lo[p.dim] = lo[p.dim] * mesh.size(m) + coord[m]
    return tuple(slice(b * k, (b + 1) * k) for b, k in zip(lo, n))


def local_dtensor(x: torch.Tensor, places, mesh) -> torch.Tensor:
    """``x``, which every rank holds whole, as a DTensor laid out by
    ``places`` on ``mesh``: this rank's block (:func:`block_slices`) is
    its shard, and no data moves."""
    from torch.distributed.tensor import DTensor

    local = x[block_slices(tuple(x.shape), places, mesh)].contiguous()
    return DTensor.from_local(local, mesh, tuple(places), run_check=False,
                              shape=x.shape, stride=x.stride())


def abstract_sharded_params(specs: ParamTree, mesh) -> ParamTree:
    """``specs`` as DTensors on ``mesh`` laid out by each leaf's spec, the
    local shards meta tensors (the reference lowers its abstract params
    with ``param_shardings`` as ``in_shardings``)."""
    def walk(tree: ParamTree) -> ParamTree:
        return {k: walk(tree[k]) if isinstance(tree[k], dict)
                else abstract_dtensor(tree[k].shape, tree[k].dtype,
                                      placements(tree[k].shape,
                                                 tree[k].pspec, mesh), mesh)
                for k in sorted(tree)}

    return walk(specs)


def register_tree(module: nn.Module, tree: ParamTree, *,
                  trainable: bool = False) -> None:
    """Hang a nested dict of tensors on ``module``: a dict becomes a child
    module, a tensor a parameter that shares the tensor's storage; it takes
    gradients only when ``trainable`` (served weights do not).
    ``state_dict`` keys are then the tree's paths joined with ``.``."""
    for name, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            register_tree(child, v, trainable=trainable)
            module.add_module(name, child)
        else:
            module.register_parameter(
                name, nn.Parameter(v, requires_grad=trainable))


class TreeModel(nn.Module):
    """A model's weights (a tree from :func:`init_params` or one to be
    filled by ``load_state_dict``) and its config.  The parameters share
    the tree's tensors; they take gradients when ``trainable``.  A model
    module subclasses it and keeps its math in module-level functions that
    take the module in place of the reference's parameter tree."""

    def __init__(self, cfg: Any, params: ParamTree, *,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        register_tree(self, params, trainable=trainable)


def nest(flat: Dict[str, Any]) -> ParamTree:
    """Dotted keys (a ``state_dict``, ``named_parameters``) → the nested
    tree they name: ``{"attn.wq": t}`` → ``{"attn": {"wq": t}}``."""
    tree: ParamTree = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def layer_slices(stacked: Dict[str, torch.Tensor]
                 ) -> list[Dict[str, torch.Tensor]]:
    """Per-layer views of stacked ``[L, ...]`` weights ({name: tensor}):
    element i is layer i's {name: slice}, the reference's ``lax.scan``
    over the stack.  Each tensor is cut once with ``torch.unbind``, whose
    backward stacks the L slices' gradients once (O(L) bytes); indexing
    ``p[i]`` a layer would make each layer's backward a
    ``select_backward`` that writes a whole ``[L, ...]`` gradient, L of
    them summed (O(L^2) bytes).  The values are the same either way."""
    names = list(stacked)
    per_name = [torch.unbind(stacked[n], 0) for n in names]
    return [dict(zip(names, layer)) for layer in zip(*per_name)]


# --------------------------------------------------------------------- #
# activation-sharding hints (DTensor redistributions; no-op without a mesh)
# --------------------------------------------------------------------- #
_HINT_MESH = None


def set_hint_mesh(mesh) -> None:
    """Install the mesh used by shard_hint (the sharded count)."""
    global _HINT_MESH
    _HINT_MESH = mesh


def hint_axis_size(name: str):
    """Size of a mesh axis under the installed hint mesh (None if no mesh)."""
    if _HINT_MESH is None:
        return None
    return _axis_sizes(_HINT_MESH).get(name)


def shard_hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's with_sharding_constraint with 'fsdp' placeholder
    resolution and divisibility sanitation: a DTensor is redistributed to
    the spec's placements (its gradient back to the input's); identity
    when no mesh is installed or ``x`` is a plain tensor."""
    if _HINT_MESH is None or not is_dtensor(x):
        return x
    names = tuple(_HINT_MESH.mesh_dim_names)
    fsdp = fsdp_axes(_HINT_MESH)
    resolved = []
    for ent in spec:
        if ent == "fsdp":
            resolved.append(fsdp)
        elif ent == "all":
            resolved.append(names)
        else:
            resolved.append(ent)
    places = placements(tuple(x.shape), tuple(resolved), _HINT_MESH)
    if tuple(x.placements) == places:
        return x
    return x.redistribute(_HINT_MESH, places)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's FSDP axes (``pod`` and ``data``, those it has)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _laid_out_full(like, shape, value, dtype, spec) -> torch.Tensor:
    """A DTensor of ``shape`` filled with ``value``, on ``like``'s mesh,
    laid out by ``spec`` (resolved and sanitised as :func:`shard_hint`
    does): each rank makes its own shard only."""
    from torch.distributed.tensor import DTensor

    mesh = like.device_mesh
    f = fsdp_axes(mesh)
    spec = tuple(f if e == "fsdp" else e for e in spec)
    places = placements(tuple(shape), spec, mesh)
    local = torch.full(local_shape(tuple(shape), places, mesh), value,
                       dtype=dtype, device=like.to_local().device)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def new_zeros(like: torch.Tensor, shape, *spec) -> torch.Tensor:
    """``like.new_zeros(shape)``; where ``like`` is a DTensor, laid out by
    ``spec`` (the layout the reference's program gives such an array) and
    made shard by shard, not whole on every rank."""
    if is_dtensor(like):
        return _laid_out_full(like, shape, 0, like.dtype, spec)
    return like.new_zeros(shape)


def zeros(like: torch.Tensor, shape, dtype: torch.dtype,
          *spec) -> torch.Tensor:
    """``torch.zeros(shape)`` on ``like``'s device; where ``like`` is a
    DTensor, laid out by ``spec`` as :func:`new_zeros`."""
    if is_dtensor(like):
        return _laid_out_full(like, shape, 0, dtype, spec)
    return torch.zeros(shape, dtype=dtype, device=like.device)


def full(like: torch.Tensor, shape, value, dtype: torch.dtype,
         *spec) -> torch.Tensor:
    """``torch.full(shape, value)`` on ``like``'s device; where ``like``
    is a DTensor, laid out by ``spec`` as :func:`new_zeros`."""
    if is_dtensor(like):
        return _laid_out_full(like, shape, value, dtype, spec)
    return torch.full(shape, value, dtype=dtype, device=like.device)


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight gathered over the FSDP axes (its other placements
    kept): the schedule GSPMD compiles the reference's 2-D-sharded
    weights to (ZeRO-3 / FSDP: a layer's weights all-gathered where the
    layer runs, their gradients reduce-scattered back).  DTensor's own
    propagation would shard the contraction instead and all-reduce
    activation-sized partial sums.  Identity without a hint mesh and on
    plain tensors."""
    if _HINT_MESH is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    fsdp = {i for i, a in enumerate(_HINT_MESH.mesh_dim_names)
            if a in fsdp_axes(_HINT_MESH)}
    if not any(w.placements[i].is_shard() for i in fsdp):
        return w
    return w.redistribute(_HINT_MESH, tuple(
        Replicate() if i in fsdp else p for i, p in enumerate(w.placements)))


def sharded_rules():
    """``analysis.sharded``, the DTensor rules of the sharded count, to
    which the functions below hand DTensor operands (loaded then, so no
    run on one device imports it)."""
    from repro_torch.analysis import sharded

    return sharded


# the model's ops whose DTensor operands take a rule of ``analysis.sharded``
def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands."""
    if is_dtensor(a) or is_dtensor(b):
        return sharded_rules().einsum(eq, a, b)
    return torch.einsum(eq, a, b)


def lookup(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` (rows in range)."""
    if is_dtensor(table):
        return sharded_rules().lookup(table, rows)
    return table[rows]


def split_heads(x: torch.Tensor, heads: int, d_head: int) -> torch.Tensor:
    """``x`` [..., heads · d_head] as [..., heads, d_head]."""
    if is_dtensor(x):
        return sharded_rules().split_heads(x, heads, d_head)
    return x.reshape(*x.shape[:-1], heads, d_head)


def take_pairs(z: torch.Tensor, i: torch.Tensor,
               j: torch.Tensor) -> torch.Tensor:
    """``z[:, i, j]``."""
    if is_dtensor(z):
        return sharded_rules().take_pairs(z, i, j)
    return z[:, i, j]


def laid_out_as(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` laid out as ``ref`` where both are DTensors (else as it is)."""
    if is_dtensor(x) and is_dtensor(ref):
        return sharded_rules().laid_out_as(x, ref)
    return x


def write_rows(cache: torch.Tensor, new: torch.Tensor, pos0: int) -> None:
    """``cache[:, pos0:pos0 + T] = new`` (T = ``new.shape[1]``), in place."""
    if is_dtensor(cache):
        sharded_rules().write_rows(cache, new, pos0)
    else:
        cache[:, pos0:pos0 + new.shape[1]] = new


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every device, as a plain tensor (a DTensor gathered,
    no gradient through it)."""
    return sharded_rules().replicated(x) if is_dtensor(x) else x


# --------------------------------------------------------------------- #
# numerics
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


class _Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g, 0)


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu``: max(x, 0) (NaN stays NaN), and a gradient that is
    ``g`` where x > 0 and 0 elsewhere, whatever ``g`` is.  torch.relu's
    backward passes ``g`` where x is NaN, so a NaN row (DLRM's lookup of
    an id out of range) would reach weights the reference keeps finite."""
    return _Relu.apply(x)


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
    g = einsum("btd,df->btf", x, w_gate.to(x.dtype))
    u = einsum("btd,df->btf", x, w_up.to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    return einsum("btf,fd->btd", h, w_down.to(x.dtype))


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
    s = einsum("bgrd,bsgd->bgrs", qh, k_cache.float())
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < cache_len
    if window is not None:
        mask &= pos[None, :] >= cache_len - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = einsum("bgrs,bsgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


# --------------------------------------------------------------------- #
# attention — chunked online-softmax (flash-style, plain torch)
# --------------------------------------------------------------------- #
def _pad_t(x: torch.Tensor, n: int) -> torch.Tensor:
    """Pad dim 1 (time) of ``x`` with ``n`` zero rows."""
    if not n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n) + x.shape[2:])], 1)


def chunked_attention(
    q: torch.Tensor,            # [B, T, H, Dh]
    k: torch.Tensor,            # [B, S, Hkv, Dh]
    v: torch.Tensor,            # [B, S, Hkv, Dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,   # sliding window (tokens), None = full
    q_offset: int = 0,              # absolute position of q[0]
    chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style attention, doubly tiled: outer loop over q blocks,
    inner over KV blocks with running (max, denom).  The live tile is
    [B, qc, Hkv, rep, kc], never the [T, S] score matrix; GQA by
    head-group broadcasting; a boolean mask as the reference's."""
    B, T, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qc, kc = min(chunk, T), min(chunk, S)
    nq, nk = (T + qc - 1) // qc, (S + kc - 1) // kc
    q = _pad_t(q, nq * qc - T)
    k = _pad_t(k, nk * kc - S)
    v = _pad_t(v, nk * kc - S)
    qb = (q.reshape(B, nq, qc, Hkv, rep, Dh) * scale).float()
    kb = k.reshape(B, nk, kc, Hkv, Dh)
    vb = v.reshape(B, nk, kc, Hkv, Dh)
    dev = q.device
    blocks = []
    for iq in range(nq):
        qi = qb[:, iq]
        q_pos = q_offset + iq * qc + torch.arange(qc, device=dev)
        m = torch.full((B, qc, Hkv, rep), NEG_INF, device=dev)
        l = torch.zeros((B, qc, Hkv, rep), device=dev)
        acc = torch.zeros((B, qc, Hkv, rep, Dh), device=dev)
        for ik in range(nk):
            key_pos = ik * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqgrd,bcgd->bqgrc", qi, kb[:, ik].float())
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= key_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - key_pos[None, :] < window
            mask &= (key_pos < S)[None, :]
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqgrc,bcgd->bqgrd", pexp, vb[:, ik].float())
            m = m_new
        blocks.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(blocks, 1).reshape(B, nq * qc, H, Dh)
    return out[:, :T].to(q.dtype)


# --------------------------------------------------------------------- #
# flash attention with its own backward (memory-bounded fwd AND bwd)
# --------------------------------------------------------------------- #
def flash_attention(q, k, v, window: Optional[int] = None, *,
                    causal: bool = True, chunk: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """Differentiable flash attention.  Forward = online-softmax double
    tiling; backward = the FlashAttention recompute scheme of the
    reference's ``custom_vjp``, saving only (q, k, v, out, lse): O(T)
    residuals instead of the O(T²/chunk) ones autograd through the tiled
    forward would keep.  ``window``: an int, or None (= 2**30)."""
    window = 2**30 if window is None else int(window)
    if is_dtensor(q):
        return sharded_rules().flash_attention(q, k, v, window, causal,
                                               chunk, q_offset)
    return _Flash.apply(q, k, v, window, causal, chunk, q_offset)


def _blockify(q, k, v, chunk: int):
    B, T, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qc, kc = min(chunk, T), min(chunk, S)
    nq, nk = (T + qc - 1) // qc, (S + kc - 1) // kc
    q = _pad_t(q, nq * qc - T)
    k = _pad_t(k, nk * kc - S)
    v = _pad_t(v, nk * kc - S)
    rep = H // Hkv
    qb = q.reshape(B, nq, qc, Hkv, rep, Dh)
    kb = k.reshape(B, nk, kc, Hkv, Dh)
    vb = v.reshape(B, nk, kc, Hkv, Dh)
    return qb, kb, vb, (B, T, S, H, Hkv, rep, Dh, qc, kc, nq, nk)


def _mask_penalty(q_pos, key_pos, S: int, window: int,
                  causal: bool) -> torch.Tensor:
    """Additive float32 penalty [qc, kc] (0 = keep, NEG_INF = mask), as
    the reference adds it to the score tile."""
    m = (key_pos < S)[None, :]
    if causal:
        m = m & (q_pos[:, None] >= key_pos[None, :])
    m = m & (q_pos[:, None] - key_pos[None, :] < window)
    return torch.where(m, 0.0, NEG_INF).to(torch.float32)


def _flash_fwd_impl(q, k, v, window: int, causal: bool, chunk: int,
                    q_offset: int):
    """(out [B, T, H, Dh] in q's type, lse [B, T, Hkv, rep] float32)."""
    qb, kb, vb, dims = _blockify(q, k, v, chunk)
    B, T, S, H, Hkv, rep, Dh, qc, kc, nq, nk = dims
    scale = 1.0 / math.sqrt(Dh)
    qb = (qb * scale).float()
    dev = q.device
    outs, lses = [], []
    for iq in range(nq):
        qi = qb[:, iq]
        q_pos = q_offset + iq * qc + torch.arange(qc, device=dev)
        m = torch.full((B, qc, Hkv, rep), NEG_INF, device=dev)
        l = torch.zeros((B, qc, Hkv, rep), device=dev)
        acc = torch.zeros((B, qc, Hkv, rep, Dh), device=dev)
        for ik in range(nk):
            key_pos = ik * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqgrd,bcgd->bqgrc", qi, kb[:, ik].float())
            pen = _mask_penalty(q_pos, key_pos, S, window, causal)
            s = s + pen[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqgrc,bcgd->bqgrd", pexp, vb[:, ik].float())
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.stack(outs, 1).reshape(B, nq * qc, H, Dh)
    out = out[:, :T].to(q.dtype)
    lse = torch.stack(lses, 1).reshape(B, nq * qc, Hkv, rep)[:, :T]
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, window: int, causal: bool,
               chunk: int, q_offset: int):
    """The reference's fused single pass (FlashAttention-2 style): outer
    loop over KV blocks emitting dK / dV a block, one float32 dQ
    accumulator; each (q, kv) tile's P is computed once."""
    qb, kb, vb, dims = _blockify(q, k, v, chunk)
    B, T, S, H, Hkv, rep, Dh, qc, kc, nq, nk = dims
    scale = 1.0 / math.sqrt(Dh)
    qb = (qb * scale).float()
    pad = nq * qc - T
    dof = dout.float()
    dob = _pad_t(dof, pad).reshape(B, nq, qc, Hkv, rep, Dh)
    lseb = _pad_t(lse, pad).reshape(B, nq, qc, Hkv, rep)
    # D_i = rowsum(dO ∘ O)
    Db = _pad_t((dof * out.float()).sum(-1).reshape(B, T, Hkv, rep),
                pad).reshape(B, nq, qc, Hkv, rep)
    dev = q.device
    dq = [torch.zeros((B, qc, Hkv, rep, Dh), device=dev) for _ in range(nq)]
    dks, dvs = [], []
    for ik in range(nk):
        ki, vi = kb[:, ik].float(), vb[:, ik].float()
        key_pos = ik * kc + torch.arange(kc, device=dev)
        dk = torch.zeros((B, kc, Hkv, Dh), device=dev)
        dv = torch.zeros((B, kc, Hkv, Dh), device=dev)
        for iq in range(nq):
            qi, doi = qb[:, iq], dob[:, iq]
            q_pos = q_offset + iq * qc + torch.arange(qc, device=dev)
            s = torch.einsum("bqgrd,bcgd->bqgrc", qi, ki)
            pen = _mask_penalty(q_pos, key_pos, S, window, causal)
            s = s + pen[None, :, None, None, :]
            p = torch.exp(s - lseb[:, iq][..., None])
            dv = dv + torch.einsum("bqgrc,bqgrd->bcgd", p, doi)
            dp = torch.einsum("bqgrd,bcgd->bqgrc", doi, vi)
            ds = p * (dp - Db[:, iq][..., None])
            dk = dk + torch.einsum("bqgrc,bqgrd->bcgd", ds, qi)
            dq[iq] = dq[iq] + torch.einsum("bqgrc,bcgd->bqgrd", ds, ki)
        dks.append(dk)
        dvs.append(dv)
    dqf = torch.stack(dq, 1).reshape(B, nq * qc, H, Dh)[:, :T]
    dkf = torch.stack(dks, 1).reshape(B, nk * kc, Hkv, Dh)[:, :S]
    dvf = torch.stack(dvs, 1).reshape(B, nk * kc, Hkv, Dh)[:, :S]
    return (dqf * scale).to(q.dtype), dkf.to(k.dtype), dvf.to(v.dtype)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom_vjp: forward ``_flash_fwd_impl``,
    residuals (q, k, v, out, lse) and nothing else, backward
    ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, chunk, q_offset):
        out, lse = _flash_fwd_impl(q, k, v, window, causal, chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (window, causal, chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.opts)
        return dq, dk, dv, None, None, None, None


# --------------------------------------------------------------------- #
# loss — chunked softmax cross-entropy (never materializes [T, vocab])
# --------------------------------------------------------------------- #
def _chunk_loss(hx: torch.Tensor, lx: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
    """One chunk's summed cross-entropy against the tied head.  The gold
    logit is ``take_along_axis``'s: a label in [-V, -1] wraps, one outside
    [-V, V) gives NaN."""
    logits = einsum("btd,vd->btv", hx.float(), emb.float())
    V = logits.shape[-1]
    lab = lx.long()
    ok = (lab >= -V) & (lab < V)
    idx = torch.where(lab < 0, lab + V, lab).clamp_(0, V - 1)
    if is_dtensor(logits):
        rules = sharded_rules()
        lse, gold = rules.logsumexp(logits), rules.take(logits, idx)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, idx[..., None]).squeeze(-1)
    gold = torch.where(ok, gold, float("nan"))
    return (lse - gold).sum()


def chunked_xent(
    h: torch.Tensor,          # [B, T, D] final hidden states
    emb: torch.Tensor,        # [V, D] (tied LM head)
    labels: torch.Tensor,     # [B, T] int
    *,
    n_chunks: int = 8,
) -> torch.Tensor:
    """Mean token cross-entropy, ``n_chunks`` chunks of the sequence one
    after another, each under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): the [chunk, vocab] logits are recomputed in the
    backward, never kept."""
    B, T, D = h.shape
    assert T % n_chunks == 0, "seq len must divide loss chunks"
    c = T // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        hx, lx = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_loss, hx, lx, emb, use_reentrant=False)
        else:
            part = _chunk_loss(hx, lx, emb)
        tot = tot + part
    return tot / (B * T)
