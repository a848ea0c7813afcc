"""XLA's cost analysis of a JAX program, split by op class, for the port's
FLOP tests.  The reference's dry-run reads ``compiled.cost_analysis()``
(one total of ``flops`` and one of ``transcendentals``); :func:`split`
walks an HLO module's text and applies the rules of XLA's
``HloCostAnalysis`` instruction by instruction, so each class can be held
against the port's count.  On the optimized module its totals reproduce
``cost_analysis()``'s (the tests check that on every program they split).

The rules (``xla/service/hlo_cost_analysis.cc``): an elementwise op costs
one FLOP an output element, a transcendental one transcendental an
element; a ``dot`` 2 · output elements · contracted elements; a ``reduce``
its reducer's cost · (input − output elements); a ``reduce-window`` its
reducer's cost · output elements · (window − 1); a ``scatter`` its
combiner's cost an update element; a ``sort`` n · ceil(log2 n) over the
operand; a fusion or call its computation's cost; layout, data movement and
custom calls (``TopK``) 0.

The same rules applied to the module as lowered, before XLA's passes,
count the program as the reference writes it.  The optimized module counts
more elementwise FLOPs: XLA:CPU fuses a cheap producer into each of its
consumers' fusions and counts every copy, and runs bf16 arithmetic in
float32 between ``convert``s.
"""

from __future__ import annotations

import collections
import math
import re
from typing import Dict, List, Tuple

CLASSES = ("matmul", "elementwise", "reduction")
TRANSCENDENTAL = frozenset({
    "exponential", "exponential-minus-one", "log", "log-plus-one",
    "logistic", "power", "sqrt", "cbrt", "rsqrt", "tanh", "sine", "cosine",
    "tan", "erf", "atan2"})
ELEMENTWISE = frozenset({
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "negate",
    "abs", "sign", "compare", "select", "clamp", "and", "or", "xor", "not",
    "convert", "remainder", "floor", "ceil", "round-nearest-afz",
    "round-nearest-even", "is-finite", "shift-left", "shift-right-logical",
    "shift-right-arithmetic", "popcnt", "count-leading-zeros", "real",
    "imag", "reduce-precision"})
FREE = frozenset({
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "reshape", "transpose", "broadcast", "slice", "dynamic-slice",
    "dynamic-update-slice", "gather", "concatenate", "pad", "copy",
    "reverse", "iota", "custom-call", "after-all", "opt-barrier",
    "bitcast-convert", "partition-id", "replica-id", "rng-bit-generator",
    "copy-start", "copy-done", "topk"})

_SHAPE = re.compile(r"[a-z]+[0-9]*\[([0-9,]*)\]")
_HEAD = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*(?:\(.*\)\s*->\s*.*)?\{$")
_INST = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+"
                   r"([a-z][\w\-]*)\((.*)$")

Cost = Dict[str, float]


def _dims(shape: str) -> List[int]:
    m = _SHAPE.search(shape)
    return [int(x) for x in m.group(1).split(",") if x] if m else []


def _elements(shape: str) -> int:
    """Elements of an array shape, or of a tuple's first element."""
    return math.prod(_dims(shape))


def _parse(text: str) -> Tuple[Dict[str, List[dict]], str]:
    comps: Dict[str, List[dict]] = {}
    cur = entry = None
    for line in text.splitlines():
        line = line.rstrip()
        head = _HEAD.match(line)
        if head:
            cur = head.group(2)
            comps[cur] = []
            if head.group(1):
                entry = cur
        elif line == "}":
            cur = None
        elif cur is not None:
            inst = _INST.match(line)
            if inst:
                name, shape, op, rest = inst.groups()
                comps[cur].append(dict(name=name, shape=shape, op=op,
                                       rest=rest))
    return comps, entry


def split(hlo_text: str) -> Tuple[Cost, Dict[str, float]]:
    """({class: FLOPs, "transcendentals": n}, {elementwise opcode:
    FLOPs}) of an HLO module, optimized (``compiled.as_text()``) or as
    lowered (``lowered.as_text("hlo")``)."""
    comps, entry = _parse(hlo_text)
    shapes = {i["name"]: i["shape"] for c in comps.values() for i in c}
    memo: Dict[str, Tuple[Cost, collections.Counter]] = {}

    def zero() -> Cost:
        return dict.fromkeys(CLASSES + ("transcendentals",), 0)

    def attr(i, key):
        m = re.search(key + r"=%?([\w.\-]+)", i["rest"])
        return m.group(1) if m else None

    def operands(i):
        return re.findall(r"%?([A-Za-z_][\w.\-]*)", i["rest"].split(")")[0])

    def comp(name: str) -> Tuple[Cost, collections.Counter]:
        """A computation's cost and its elementwise FLOPs by opcode."""
        if name not in memo:
            tot, by = zero(), collections.Counter()
            for i in comps[name]:
                cost, sub = inst(i)
                for k, v in cost.items():
                    tot[k] += v
                by.update(sub)
            memo[name] = tot, by
        return memo[name]

    def applied(sub: Cost, times: float) -> Cost:
        """A reducer or combiner applied ``times``: its FLOPs count in the
        reduction class."""
        out = zero()
        out["reduction"] = times * sum(sub[c] for c in CLASSES)
        out["transcendentals"] = times * sub["transcendentals"]
        return out

    def inst(i) -> Tuple[Cost, collections.Counter]:
        op, z, none = i["op"], zero(), collections.Counter()
        if op in FREE:
            return z, none
        n = _elements(i["shape"])
        if op in TRANSCENDENTAL:
            z["transcendentals"] = n
        elif op in ELEMENTWISE:
            z["elementwise"] = n
            return z, collections.Counter({op: n})
        elif op == "dot":
            lhs = _dims(shapes[operands(i)[0]])
            m = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", i["rest"])
            k = math.prod(lhs[int(d)] for d in m.group(1).split(",") if d)
            z["matmul"] = 2 * n * k
        elif op in ("fusion", "call"):
            return comp(attr(i, "calls") or attr(i, "to_apply"))
        elif op in ("reduce", "all-reduce"):
            sub = comp(attr(i, "to_apply"))[0]
            return applied(sub, _elements(shapes[operands(i)[0]]) - n), none
        elif op == "reduce-window":
            sub = comp(attr(i, "to_apply"))[0]
            m = re.search(r"window=\{size=([0-9x]+)", i["rest"])
            w = math.prod(int(x) for x in m.group(1).split("x"))
            return applied(sub, n * (w - 1)), none
        elif op == "scatter":
            sub = comp(attr(i, "to_apply"))[0]
            ops = operands(i)
            return applied(sub, _elements(
                shapes[ops[(len(ops) + 1) // 2]])), none
        elif op == "sort":
            e = _elements(shapes[operands(i)[0]])
            z["reduction"] = e * max(e - 1, 0).bit_length()
        elif op == "while":
            (b, bb), (c, cb) = comp(attr(i, "body")), comp(attr(i,
                                                               "condition"))
            return {k: b[k] + c[k] for k in b}, bb + cb
        else:
            raise NotImplementedError(f"no cost rule for HLO op {op!r}")
        return z, none

    cost, by = comp(entry)
    return cost, dict(by)


def compiled_cost(fn, *args, **jit_kwargs) -> Dict[str, tuple]:
    """``fn`` jitted, lowered and compiled for ``args`` (arrays or
    ``ShapeDtypeStruct``s): {"compiled": (the optimized module's split,
    its elementwise FLOPs by opcode), "lowered": (the same of the module
    before XLA's passes), "totals": ``cost_analysis()``'s ``flops`` and
    ``transcendentals``}."""
    import jax

    lowered = jax.jit(fn, **jit_kwargs).lower(*args)
    compiled = lowered.compile()
    ca = compiled.cost_analysis() or {}
    if isinstance(ca, list):
        ca = ca[0]
    return dict(compiled=split(compiled.as_text()),
                lowered=split(lowered.as_text("hlo")),
                totals={k: float(ca.get(k, 0.0))
                        for k in ("flops", "transcendentals")})
