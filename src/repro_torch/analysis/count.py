"""Work of one run of a step, counted from its operations and their shapes:
the port's counterpart of ``repro/analysis/hlo.py``.

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of a
compiled program and parses collective bytes out of its HLO text.  The port
has no compiler: :class:`WorkCounter` is a ``TorchDispatchMode`` that sees
every aten op the run dispatches and totals

  * FLOPs as XLA's cost analysis (the reference's dry-run) counts them,
    by op class (:data:`FLOP_CLASSES`): ``matmul``,
    ``torch.utils.flop_counter``'s registered formulas (matmuls,
    convolutions, attention) and the port's own for the matrix-vector
    and vector products it lacks (``mv``, ``addmv``, ``dot``, ``vdot``:
    2 · multiply-adds); ``elementwise``, a FLOP an output element for
    arithmetic, comparisons, selects and dtype conversions, and the
    arithmetic XLA:CPU expands ``sigmoid``, ``silu``, ``acos`` and an
    integer power into; ``reduction``, a reduction's input less output
    elements (XLA's ``reduce``), a scatter-add's source elements (its
    combiner), a sort's n · ceil(log2 n); ``kernel``, the hand kernels'
    operations (below).  Transcendentals (``exp``, ``log``, ``rsqrt``,
    ``sigmoid``'s ``exp``…) are counted apart, as XLA counts them, and
    are not FLOPs.  Layout and data movement (views, ``clone``,
    ``copy_``, ``cat``, ``index``, ``gather``; ``topk``, a custom call
    XLA costs at 0) count 0 (:data:`EXTRA_FLOPS`);
  * bytes: each op's tensor inputs plus its outputs — the port fuses
    nothing, so that is its memory traffic.  Views count 0.  An op that
    moves a tensor between the host and a device counts its output under
    ``transfer_bytes`` instead (on the CPU there is no such op);
  * collective bytes by kind, under ``hlo.py``'s convention (the bytes of
    the op's output): the ``c10d`` ops (whose first argument is their
    output) and the functional collectives DTensor issues
    (``_c10d_functional``, whose output is their result; ``wait_tensor``
    counts nothing) map onto ``all-reduce``, ``all-gather``,
    ``reduce-scatter`` and ``all-to-all``; the aten ops a process group's
    backend runs inside them are not counted.  Each collective is also
    listed in program order (``collective_ops``, the counterpart of
    ``hlo.collective_ops``).  A shard → shard redistribution counts as
    one ``all-to-all`` of its output, whatever a CPU-typed mesh lowers it
    to (:func:`capture_dtensor`);
  * the hand-written kernels by their own formulas: each public kernel op
    enters :func:`repro_torch.kernels.work_scope`, which records one unit
    of the kernel with its ``<name>/cost.py`` work (operations and the
    least bytes, the figures its bound uses) and hides the aten ops inside
    — so the plain version on the CPU and the kernel on the card count the
    same.  A unit's operations add to the FLOPs and its bytes to the bytes.

The same counter runs on meta tensors (the dry-run's abstract count: a
cell at its full shape with no memory), where every op dispatches for its
output's shape alone and counts as on the card.  On DTensors (the sharded
count: one rank of a fake process group, ``launch.mesh.
make_production_mesh``) it counts that rank's local work: an op on
DTensors is passed on (``NotImplemented``), so the counter sees the local
ops DTensor runs on each shard and the collectives it issues, and, within
:func:`capture_dtensor`, not the ops by which DTensor propagates
shardings (on ``FakeTensor``s or on global-shape tensors).  On meta it also tallies
the bytes of the storages the run creates, alive at once at the peak
(:class:`StorageTally`): the run's temporary memory.  On the card the
tally is asked for where it is held against the allocator's peak.

The reference's HLO-text parser itself is not ported: the counter's
``collectives`` and ``collective_ops`` stand for its ``collective_bytes``
and ``collective_ops``; ``count_op`` has no counterpart.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

#: ``c10d`` op (without its overload) → ``hlo.py``'s collective kind.
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
#: Functional collective (``_c10d_functional``, ``_c10d_functional_autograd``,
#: ``_dtensor``) → ``hlo.py``'s kind, counted by the bytes of its output;
#: the other ops of those namespaces (``wait_tensor``, wrappers) count 0.
FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_FUNCTIONAL = frozenset({"_c10d_functional", "_c10d_functional_autograd",
                         "_dtensor"})
#: aten ops that return a tensor sharing its input's memory without being
#: marked as views in their schema.
_VIEW_LIKE = frozenset({"_unsafe_view", "lift_fresh", "alias"})


#: The classes the counted FLOPs split into (``flops_by_class``).
FLOP_CLASSES = ("matmul", "elementwise", "reduction", "kernel")
#: Counted work of one op: {class: FLOPs, "transcendentals": n}.
Flops = Dict[str, int]


def _numel(x) -> int:
    """Elements of a tensor, or of the first tensor of an op's outputs."""
    if isinstance(x, (list, tuple)):
        return _numel(x[0])
    return x.numel() if isinstance(x, torch.Tensor) else 1


def _mv_flops(mat, vec, *args, **kwargs) -> Flops:
    return {"matmul": 2 * mat.shape[0] * mat.shape[1]}


def _addmv_flops(self, mat, vec, *args, **kwargs) -> Flops:
    return {"matmul": 2 * mat.shape[0] * mat.shape[1]}


def _dot_flops(a, b, *args, **kwargs) -> Flops:
    return {"matmul": 2 * a.shape[0]}


def _per_element(flops: int, transcendentals: int = 0) -> Callable:
    """An elementwise op: ``flops`` FLOPs and ``transcendentals`` an
    output element (XLA counts each elementwise HLO op once an element)."""
    def formula(*args, out_val=None, **kwargs) -> Flops:
        n = _numel(out_val)
        return {"elementwise": flops * n,
                "transcendentals": transcendentals * n}
    return formula


def _pow_scalar_flops(x, exponent, *args, out_val=None, **kwargs) -> Flops:
    """``x ** e`` as XLA counts ``jnp``'s: an integer e by repeated
    squaring (floor(log2 |e|) + popcount(|e|) - 1 multiplies, and a
    divide where e < 0), any other e one ``power`` (or ``sqrt`` /
    ``rsqrt``) transcendental."""
    n = _numel(out_val)
    e = float(exponent)
    if e.is_integer() and e != 0:
        k = int(abs(e))
        muls = k.bit_length() - 1 + bin(k).count("1") - 1
        return {"elementwise": (muls + (e < 0)) * n}
    return {"transcendentals": 0 if e == 0 else n}


def _to_copy_flops(x, *args, out_val=None, **kwargs) -> Flops:
    """A dtype change is XLA's ``convert``, one FLOP an element; a copy
    that keeps the dtype is data movement."""
    return {"elementwise": _numel(out_val) if out_val.dtype != x.dtype
            else 0}


def _reduce(elementwise_out: int = 0) -> Callable:
    """A reduction of ``x`` (its first argument): input less output
    elements (XLA's ``reduce``), plus ``elementwise_out`` FLOPs an output
    element (``mean``'s divide)."""
    def formula(x, *args, out_val=None, **kwargs) -> Flops:
        n_out = _numel(out_val)
        return {"reduction": x.numel() - n_out,
                "elementwise": elementwise_out * n_out}
    return formula


def _rows(x, dim) -> int:
    """Rows of a softmax-like op over ``dim``: x's elements over that
    axis's length."""
    return x.numel() // max(x.shape[dim], 1) if x.dim() else 1


def _softmax_flops(x, dim, *args, **kwargs) -> Flops:
    """``jax.nn.softmax``: max, subtract, exp, sum, divide."""
    n, r = x.numel(), _rows(x, dim)
    return {"elementwise": 2 * n, "reduction": 2 * (n - r),
            "transcendentals": n}


def _log_softmax_flops(x, dim, *args, **kwargs) -> Flops:
    """``jax.nn.log_softmax``: max, subtract, exp, sum, log, subtract."""
    n, r = x.numel(), _rows(x, dim)
    return {"elementwise": 3 * n, "reduction": 2 * (n - r),
            "transcendentals": n + r}


def _softmax_bwd_flops(grad, out, dim, *args, **kwargs) -> Flops:
    """y · (g - sum(g · y)): two multiplies and a subtract an element, a
    sum a row."""
    n, r = grad.numel(), _rows(grad, dim)
    return {"elementwise": 3 * n, "reduction": n - r}


def _log_softmax_bwd_flops(grad, out, dim, *args, **kwargs) -> Flops:
    """g - exp(y) · sum(g): an exp, a multiply and a subtract an element,
    a sum a row."""
    n, r = grad.numel(), _rows(grad, dim)
    return {"elementwise": 2 * n, "reduction": n - r, "transcendentals": n}


def _logsumexp_flops(x, *args, out_val=None, **kwargs) -> Flops:
    """``jax.nn.logsumexp``: max (its finite check and select), subtract,
    exp, sum, log, add."""
    n, r = x.numel(), _numel(out_val)
    return {"elementwise": n + 4 * r, "reduction": 2 * (n - r),
            "transcendentals": n + r}


def _norm_flops(x, *args, out_val=None, **kwargs) -> Flops:
    """The 2-norm: a square an element, a sum, a sqrt an output."""
    n, r = x.numel(), _numel(out_val)
    return {"elementwise": n, "reduction": n - r, "transcendentals": r}


def _scatter_add_flops(x, dim, index, src, *args, **kwargs) -> Flops:
    """A scatter-add (``index_add``, ``scatter_add``, ``scatter_reduce``):
    its combiner once a source element (XLA's ``scatter``)."""
    return {"reduction": src.numel()}


def _index_put_flops(x, indices, values, accumulate=False, *args,
                     **kwargs) -> Flops:
    """``index_put``: a scatter-add with ``accumulate``, else a scatter
    that overwrites (no combiner FLOPs)."""
    return {"reduction": values.numel() if accumulate else 0}


def _sort_flops(x, *args, **kwargs) -> Flops:
    """XLA's cost of a ``sort``: n · ceil(log2 n), n the elements of the
    whole operand."""
    n = x.numel()
    return {"reduction": n * max(n - 1, 0).bit_length()}


def _searchsorted_flops(sorted_seq, values, *args, out_val=None,
                        **kwargs) -> Flops:
    """A binary search: ceil(log2(n + 1)) compares a query."""
    n = sorted_seq.shape[-1]
    return {"elementwise": _numel(out_val) * n.bit_length()}


def _cumsum_flops(x, *args, **kwargs) -> Flops:
    """An add an element."""
    return {"reduction": x.numel()}


def _pow_flops(x, exponent, *args, out_val=None, **kwargs) -> Flops:
    """A tensor to a number: :func:`_pow_scalar_flops`; a tensor
    exponent or a number's base: one ``power`` an element."""
    if isinstance(x, torch.Tensor) and not isinstance(exponent,
                                                      torch.Tensor):
        return _pow_scalar_flops(x, exponent, out_val=out_val)
    return {"transcendentals": _numel(out_val)}


_reduce_flops = _reduce()


def _max_min_flops(x, *args, out_val=None, **kwargs) -> Flops:
    """``max`` / ``min``: of two tensors, an elementwise op; of one, a
    reduction."""
    if args and isinstance(args[0], torch.Tensor):
        return {"elementwise": _numel(out_val)}
    return _reduce_flops(x, out_val=out_val)


#: Arithmetic, comparisons, selects, bit ops: one FLOP an output element.
_ELEMENTWISE = (
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sgn", "sign",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where",
    "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_not", "logical_xor", "__lshift__", "__rshift__", "relu",
    "reciprocal", "masked_fill", "floor", "ceil", "round", "trunc")
#: One transcendental an output element.
_TRANSCENDENTAL = ("exp", "log", "log1p", "expm1", "sqrt", "rsqrt", "sin",
                   "cos", "tan", "tanh", "erf", "atan2")
_FORMULAS: Dict[str, Callable] = {
    "mv": _mv_flops, "addmv": _addmv_flops, "dot": _dot_flops,
    "vdot": _dot_flops,
    **{n: _per_element(1) for n in _ELEMENTWISE},
    **{n: _per_element(0, 1) for n in _TRANSCENDENTAL},
    "sigmoid": _per_element(3, 1),
    "sigmoid_backward": _per_element(3),       # g · y · (1 - y)
    "tanh_backward": _per_element(3),          # g · (1 - y²)
    "silu": _per_element(4, 1),
    "silu_backward": _per_element(8, 1),       # recomputes the sigmoid
    "threshold_backward": _per_element(2),     # compare, select
    "acos": _per_element(3, 2),
    "floor_divide": _per_element(8),
    "remainder": _per_element(6),
    "pow": _pow_flops,
    "_to_copy": _to_copy_flops,
    **dict.fromkeys(("sum", "amax", "amin", "any", "all", "argmax",
                     "argmin"), _reduce_flops),
    "max": _max_min_flops, "min": _max_min_flops,
    "mean": _reduce(elementwise_out=1),
    "linalg_vector_norm": _norm_flops,
    "logsumexp": _logsumexp_flops,
    "_softmax": _softmax_flops,
    "_log_softmax": _log_softmax_flops,
    "_softmax_backward_data": _softmax_bwd_flops,
    "_log_softmax_backward_data": _log_softmax_bwd_flops,
    "cumsum": _cumsum_flops,
    "index_add": _scatter_add_flops, "scatter_add": _scatter_add_flops,
    "scatter_reduce": _scatter_add_flops,
    "index_put": _index_put_flops,
    "sort": _sort_flops,
    "searchsorted": _searchsorted_flops,
}
_aten = torch.ops.aten
#: FLOP formulas of ops that ``flop_registry`` lacks (kept here: the
#: global registry is torch's, not the port's), by overload packet: each
#: returns its FLOPs by class and its transcendentals.  An in-place
#: variant counts as its op.  The composites' counts are what XLA:CPU
#: counts for the ``jnp`` op the reference writes: ``sigmoid`` as
#: 1 / (1 + exp(-x)), ``silu`` as x · sigmoid, ``acos`` through ``atan2``
#: and ``sqrt``, integer ``floor_divide`` / ``remainder`` with their sign
#: fixes.
EXTRA_FLOPS: Dict[Any, Callable] = {
    getattr(_aten, name + inplace): f for name, f in _FORMULAS.items()
    for inplace in ("", "_") if hasattr(_aten, name + inplace)}


def op_flops(func, args: tuple, kwargs: dict, out) -> Flops:
    """An aten op's FLOPs by class and transcendentals ({} for an op
    that counts none: views, copies, indexing, factories)."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return {"matmul": int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))}
    formula = EXTRA_FLOPS.get(packet)
    return formula(*args, **kwargs, out_val=out) if formula else {}


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "_local_tensor")


def _tensors(x) -> list:
    """The tensors in ``x`` (a DTensor's local shard in its place)."""
    if isinstance(x, torch.Tensor):
        return [x._local_tensor if _is_dtensor(x) else x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


#: aten copies that may move a tensor between the host and a device.
_COPIES = frozenset({"_to_copy", "copy_", "_copy_from",
                     "_copy_from_and_resize"})


def _crosses_devices(name: str, ins: list, outs: list) -> bool:
    """Does this copy move data between device types (host ↔ card)?"""
    return name in _COPIES and len(
        {t.device.type for t in ins[:2] + outs}) > 1


class _Hidden:
    """``fn`` called with every op inside hidden from the active
    :class:`WorkCounter` (any other attribute is ``fn``'s)."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def __call__(self, *args, **kwargs):
        if not kernels.work_counters:
            return self._fn(*args, **kwargs)
        return kernels.work_counters[-1].run_hidden(self._fn, *args,
                                                    **kwargs)

    def __getattr__(self, name: str):
        return getattr(self._fn, name)


_CAPTURE_DEPTH = 0


@contextlib.contextmanager
def capture_dtensor():
    """Within: a :class:`WorkCounter` counts a DTensor program as one rank
    runs it.  On exit torch's own functions are back in place (nested
    uses restore once, at the outermost exit); with no counter active
    DTensor runs as torch has it even within.

      * DTensor's sharding propagation (``ShardingPropagator.
        propagate_op_sharding``, its cache and what it calls) is hidden:
        on a cache miss it may run ops on global-shape tensors, which are
        no rank's work;
      * a shard → shard redistribution (``Shard._to_new_shard_dim`` →
        ``placement_types.shard_dim_alltoall``) counts as one
        ``all-to-all`` of its output bytes, the ops inside hidden.  On a
        mesh of device type ``"cpu"`` torch lowers it to an all-gather of
        the whole tensor and a chunk ("CPU process group does not support
        alltoall yet"); the program asks for an all-to-all, and that is
        what the count records."""
    global _CAPTURE_DEPTH
    from torch.distributed.tensor import DTensor, placement_types

    prop = DTensor._op_dispatcher.sharding_propagator
    names = ("propagate_op_sharding", "propagate_op_sharding_non_cached")
    if _CAPTURE_DEPTH == 0:
        original = placement_types.shard_dim_alltoall

        def shard_dim_alltoall(*args, **kwargs):
            if not kernels.work_counters:
                return original(*args, **kwargs)
            wc = kernels.work_counters[-1]
            out = wc.run_hidden(original, *args, **kwargs)
            wc.collective("all-to-all", _nbytes(_tensors(out)))
            return out

        # the propagator's own attributes (the cache is one, the method
        # under it is the class's), to put back on exit
        saved = {name: vars(prop).get(name) for name in names}
        for name in names:
            setattr(prop, name, _Hidden(getattr(prop, name)))
        placement_types.shard_dim_alltoall = shard_dim_alltoall
    _CAPTURE_DEPTH += 1
    try:
        yield
    finally:
        _CAPTURE_DEPTH -= 1
        if _CAPTURE_DEPTH == 0:
            for name, own in saved.items():
                if own is None:
                    delattr(prop, name)
                else:
                    setattr(prop, name, own)
            placement_types.shard_dim_alltoall = original


class StorageTally:
    """Bytes of the storages a run creates on one device type, alive at
    once: ``live`` now, ``peak`` the most.  A storage is counted when an
    op of the run first returns or reads it (a kernel's output when the
    next op reads it) and dropped when it is freed (``weakref.finalize``
    on the storage, whose Python object lives as long as the storage
    does).  ``known`` storages (the run's arguments) are never counted."""

    def __init__(self, device_type: str, known: Iterable[torch.Tensor] = ()):
        self.device_type = device_type
        self.live = self.peak = 0
        self._seen = {t.untyped_storage()._cdata for t in known
                      if t.device.type == device_type}
        self._finalizers: list = []

    def add(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._finalizers.append(weakref.finalize(st, self._free, key,
                                                     n))

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def close(self) -> None:
        """Stop tracking (the storages alive now stay counted in
        ``peak``)."""
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()


class WorkCounter(TorchDispatchMode):
    """Totals of the ops dispatched while it is entered (``with
    WorkCounter() as wc:``); :meth:`summary` returns them.  Kernel ops
    report to the innermost active counter.  ``tally``, where given,
    counts the storages the run's ops create (:class:`StorageTally`)."""

    def __init__(self, tally: Optional[StorageTally] = None):
        super().__init__()
        self.tally = tally
        self.flops = 0
        self.transcendentals = 0
        self.flops_by_class: Dict[str, int] = dict.fromkeys(FLOP_CLASSES, 0)
        self.bytes = 0
        self.transfer_bytes = 0
        self.collectives: Dict[str, int] = collections.Counter()
        #: (kind, bytes) of each collective, in program order
        self.collective_ops: list = []
        self.kernels: Dict[str, Dict[str, Any]] = {}
        #: per aten op: [calls, flops, bytes, transcendentals] (what
        #: differs where two runs disagree)
        self.by_op: Dict[str, list] = {}
        self._hidden = 0

    def __enter__(self):
        kernels.work_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.work_counters.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel_scope(self, kernel: str, work_fn: Callable, args: tuple,
                     kwargs: dict):
        """One unit of ``kernel``'s work, ``work_fn(*args, **kwargs)``;
        the ops inside, and those the formula runs, are hidden."""
        self._hidden += 1
        try:
            work = work_fn(*args, **kwargs)
        except BaseException:
            self._hidden -= 1
            raise
        rec = self.kernels.setdefault(kernel, dict(
            units=0, ops=0, op_class=work.op_class, bytes=0))
        rec["units"] += 1
        rec["ops"] += work.ops
        rec["bytes"] += work.bytes
        if self._hidden == 1:
            self.flops += work.ops
            self.flops_by_class["kernel"] += work.ops
            self.bytes += work.bytes
        try:
            yield
        finally:
            self._hidden -= 1

    def collective(self, kind: str, n_bytes: int) -> None:
        """Record one collective of ``kind`` whose output is ``n_bytes``."""
        self.collectives[kind] += n_bytes
        self.collective_ops.append((kind, n_bytes))

    def run_hidden(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` with every op inside hidden."""
        self._hidden += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._hidden -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._hidden:
            return func(*args, **kwargs)
        if any(t.__name__ == "DTensor" for t in types):
            # DTensor runs the op again on the local shards, and here
            return NotImplemented
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            out = self.run_hidden(func, *args, **kwargs)
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:    # the in-place ops' first argument
                self.collective(kind, _nbytes(_tensors(args[0])))
            return out
        if func.namespace in _FUNCTIONAL:
            out = self.run_hidden(func, *args, **kwargs)
            kind = FUNCTIONAL_KINDS.get(name)
            if kind is not None:
                self.collective(kind, _nbytes(_tensors(out)))
            return out
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            # DTensor's sharding propagation, on global shapes
            return out
        if self.tally is not None:
            # a view's input may be a storage no op has read yet
            self.tally.add(ins + outs)
        if func.is_view or name in _VIEW_LIKE:
            return out
        if _crosses_devices(name, ins, outs):
            self.transfer_bytes += _nbytes(outs)
            return out
        work = op_flops(func, args, kwargs, out)
        flops = 0
        for cls in FLOP_CLASSES:
            n = int(work.get(cls, 0))
            self.flops_by_class[cls] += n
            flops += n
        transcendentals = int(work.get("transcendentals", 0))
        n_bytes = _nbytes(ins) + _nbytes(outs)
        self.flops += flops
        self.transcendentals += transcendentals
        self.bytes += n_bytes
        rec = self.by_op.setdefault(str(func), [0, 0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += n_bytes
        rec[3] += transcendentals
        return out

    def summary(self) -> Dict[str, Any]:
        return dict(flops=self.flops, transcendentals=self.transcendentals,
                    flops_by_class=dict(self.flops_by_class),
                    bytes=self.bytes, transfer_bytes=self.transfer_bytes,
                    collectives=dict(self.collectives),
                    collective_ops=[list(c) for c in self.collective_ops],
                    kernels={k: dict(v) for k, v in
                             sorted(self.kernels.items())})


def storage_bytes(tree, device_type: Optional[str] = None) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (those on
    ``device_type`` where it is given)."""
    seen = {}
    for t in _tensors(tree):
        if device_type is not None and t.device.type != device_type:
            continue
        s = t.untyped_storage()
        seen[(t.device, s._cdata)] = s.nbytes()
    return sum(seen.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn: Callable, inputs: tuple, device: torch.device,
            tally: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """One counted run of ``fn(*inputs)`` on ``device``: its outputs, and
    a record of the counter's totals, the run's time and ``memory``:
    ``argument_bytes`` (the inputs' storages on the device: parameters,
    optimizer state, batch; not a batch's host copies), ``output_bytes``
    (the outputs' storages) and ``temp_bytes``.

    On the card: ``run_s`` (CUDA events; the counter's own host cost
    included), ``temp_bytes`` the peak allocated during the run less the
    arguments, and with ``tally`` ``tally_temp_bytes``, the
    :class:`StorageTally`'s peak, beside it (the tally's host cost then
    in ``run_s``).  On meta (the abstract count), always tallied:
    ``host_s`` (the host clock: no device runs), ``temp_bytes`` the
    tally's peak.  On the CPU: ``run_s`` on the host clock,
    ``temp_bytes`` None."""
    device = torch.device(device)
    kind = device.type
    arg_bytes = storage_bytes(inputs, kind)
    if kind == "meta" or (kind == "cuda" and tally):
        tally = StorageTally(kind, _tensors(inputs))
    else:
        tally = None
    _sync(device)
    if kind == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    try:
        with WorkCounter(tally) as wc:
            out = fn(*inputs)
    finally:
        if kind == "cuda":
            stop.record()
        if tally is not None:
            tally.close()
    host_s = time.perf_counter() - t0
    memory = dict(argument_bytes=arg_bytes,
                  output_bytes=storage_bytes(out, kind), temp_bytes=None)
    rec = wc.summary()
    if kind == "cuda":
        _sync(device)
        rec["run_s"] = start.elapsed_time(stop) / 1e3
        memory["temp_bytes"] = (torch.cuda.max_memory_allocated(device)
                                - arg_bytes)
        if tally is not None:
            memory["tally_temp_bytes"] = tally.peak
    elif kind == "meta":
        rec["host_s"] = host_s
        memory["temp_bytes"] = tally.peak
    else:
        rec["run_s"] = host_s
    rec.update(by_op=wc.by_op, memory=memory)
    return out, rec
