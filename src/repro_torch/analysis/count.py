"""Work of one run of a step, counted from its operations and their shapes:
the port's counterpart of ``repro/analysis/hlo.py``.

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of a
compiled program and parses collective bytes out of its HLO text.  The port
has no compiler: :class:`WorkCounter` is a ``TorchDispatchMode`` that sees
every aten op the run dispatches and totals

  * FLOPs: ``torch.utils.flop_counter``'s registered formulas (matmuls,
    convolutions, attention); 0 for an op without one;
  * bytes: each op's tensor inputs plus its outputs — the port fuses
    nothing, so that is its memory traffic.  Views count 0.  An op that
    moves a tensor between the host and a device counts its output under
    ``transfer_bytes`` instead (on the CPU there is no such op);
  * collective bytes by kind, under ``hlo.py``'s convention (the bytes of
    the op's output): the ``c10d`` ops map onto ``all-reduce``,
    ``all-gather``, ``reduce-scatter`` and ``all-to-all``; the aten ops a
    process group's backend runs inside them are not counted;
  * the hand-written kernels by their own formulas: each public kernel op
    enters :func:`repro_torch.kernels.work_scope`, which records one unit
    of the kernel with its ``<name>/cost.py`` work (operations and the
    least bytes, the figures its bound uses) and hides the aten ops inside
    — so the plain version on the CPU and the kernel on the card count the
    same.  A unit's operations add to the FLOPs and its bytes to the bytes.

The reference's HLO-text parser (``collective_bytes``, ``collective_ops``,
``count_op``) has no meaning for torch and is not ported.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Callable, Dict, Tuple

import torch
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
#: aten ops that return a tensor sharing its input's memory without being
#: marked as views in their schema.
_VIEW_LIKE = frozenset({"_unsafe_view", "lift_fresh", "alias"})


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
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


class WorkCounter(TorchDispatchMode):
    """Totals of the ops dispatched while it is entered (``with
    WorkCounter() as wc:``); :meth:`summary` returns them.  Kernel ops
    report to the innermost active counter."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transfer_bytes = 0
        self.collectives: Dict[str, int] = collections.Counter()
        self.kernels: Dict[str, Dict[str, Any]] = {}
        #: per aten op: [calls, flops, bytes] (what differs where two runs
        #: disagree)
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
            self.bytes += work.bytes
        try:
            yield
        finally:
            self._hidden -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._hidden:
            return func(*args, **kwargs)
        if func.namespace == "c10d":
            self._hidden += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self._hidden -= 1
            kind = COLLECTIVE_KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                self.collectives[kind] += _nbytes(_tensors(args[0]))
            return out
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.is_view or name in _VIEW_LIKE:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _crosses_devices(name, ins, outs):
            self.transfer_bytes += _nbytes(outs)
            return out
        formula = flop_registry.get(func._overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula else 0
        n_bytes = _nbytes(ins) + _nbytes(outs)
        self.flops += flops
        self.bytes += n_bytes
        rec = self.by_op.setdefault(str(func), [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += n_bytes
        return out

    def summary(self) -> Dict[str, Any]:
        return dict(flops=self.flops, bytes=self.bytes,
                    transfer_bytes=self.transfer_bytes,
                    collectives=dict(self.collectives),
                    kernels={k: dict(v) for k, v in
                             sorted(self.kernels.items())})


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[(t.device, s.data_ptr())] = s.nbytes()
    return sum(seen.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn: Callable, inputs: tuple, device: torch.device
            ) -> Tuple[Any, Dict[str, Any]]:
    """One counted run of ``fn(*inputs)`` on ``device``: its outputs, and
    a record of the counter's totals, ``run_s`` (CUDA events on the card,
    the host clock on the CPU; the counter's own host cost included) and
    ``memory``:
    ``argument_bytes`` (the inputs' storages: parameters, optimizer state,
    batch), ``output_bytes`` (the outputs' storages) and ``temp_bytes``
    (on the card the peak allocated during the run less the arguments; on
    the CPU None)."""
    device = torch.device(device)
    arg_bytes = storage_bytes(inputs)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    with WorkCounter() as wc:
        out = fn(*inputs)
    if device.type == "cuda":
        stop.record()
        _sync(device)
        run_s = start.elapsed_time(stop) / 1e3
        temp = torch.cuda.max_memory_allocated(device) - arg_bytes
    else:
        run_s, temp = time.perf_counter() - t0, None
    rec = wc.summary()
    rec.update(run_s=run_s, by_op=wc.by_op, memory=dict(
        argument_bytes=arg_bytes, output_bytes=storage_bytes(out),
        temp_bytes=temp))
    return out, rec
