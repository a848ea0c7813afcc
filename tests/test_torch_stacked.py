"""Stacked ``[L, ...]`` layer weights cut once a forward
(``models.common.layer_slices``, ``torch.unbind``) against the layer-by-
layer indexing they replace: the same gradients bit for bit in float32 on
the CPU, and a backward whose weight gradients take O(L) bytes (no
``select_backward`` of a stacked weight, which wrote a whole ``[L, ...]``
gradient a layer)."""

from __future__ import annotations

import dataclasses
import importlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import count
from repro_torch.configs import registry as treg
from repro_torch.models import common as MC
from repro_torch.models import transformer as TM
from repro_torch.train import step as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indexed_slices(stacked):
    """The slicing the port had: layer i's weights indexed ``p[i]``, one
    ``select`` a layer and weight."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


_MODULES = {"gemma3-1b": "gemma3_1b", "qwen3-moe-235b-a22b":
            "qwen3_moe_235b", "gatedgcn": "gatedgcn_cfg",
            "dimenet": "dimenet_cfg", "equiformer-v2": "equiformer_v2_cfg",
            "graphsage-reddit": "graphsage_reddit",
            "dlrm-mlperf": "dlrm_mlperf"}


def _smoke(arch_id) -> dict:
    s = importlib.import_module("repro_torch.configs."
                                + _MODULES[arch_id]).SMOKE
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.name != "name"}


#: (arch, shape, cut): the stacked-layer training steps at SMOKE widths,
#: float32.
STACKED = [
    ("gemma3-1b", "train_4k", dict(seq=32, batch=2, dtype=torch.float32)),
    ("qwen3-moe-235b-a22b", "train_4k",
     dict(seq=32, batch=2, dtype=torch.float32)),
    ("gatedgcn", "molecule", {}),
    ("dimenet", "molecule", {}),
    ("equiformer-v2", "molecule", {}),
]


def _grads(arch_id, shape, cut):
    """(loss, the gradient tree's leaves by path) of the cell's SMOKE step
    on the CPU."""
    arch = treg.get(arch_id)
    built = arch.build(shape, {**_smoke(arch_id), **cut})
    params, _, batch = built.make_inputs("cpu", 0)
    if arch.family == "lm":
        model_cls, loss_fn = TM.Transformer, TM.loss_fn
    else:
        module = importlib.import_module(
            "repro_torch.models.gnn." + arch_id.replace("-", "_"))
        model_cls, loss_fn = module.MODEL, module.loss_fn
    loss, grads = TS.loss_and_grads(params, batch, built.cfg,
                                    model_cls=model_cls, loss_fn=loss_fn)
    flat = {}

    def walk(tree, path=""):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            else:
                flat[path + k] = v
    walk(grads)
    return loss, flat


@pytest.mark.parametrize("arch_id,shape,cut", STACKED,
                         ids=[c[0] for c in STACKED])
def test_gradients_equal_indexed_slices_bit_for_bit(monkeypatch, arch_id,
                                                    shape, cut):
    """The loss and every weight's gradient equal, bit for bit, those of
    the same step with each layer's weights indexed from the stack."""
    loss, got = _grads(arch_id, shape, cut)
    monkeypatch.setattr(MC, "layer_slices", _indexed_slices)
    want_loss, want = _grads(arch_id, shape, cut)
    assert torch.equal(loss, want_loss)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


class _SelectBackwards(TorchDispatchMode):
    """The input sizes of every ``select_backward`` dispatched."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.select_backward.default:
            self.sizes.append(tuple(args[1]))
        return func(*args, **(kwargs or {}))


#: Every family's training step at SMOKE widths.
TRAINING = [c[:2] + ({k: v for k, v in c[2].items() if k != "dtype"},)
            for c in STACKED] + [("graphsage-reddit", "full_graph_sm", {}),
                                 ("dlrm-mlperf", "train_batch", {})]


@pytest.mark.parametrize("arch_id,shape,cut", TRAINING,
                         ids=[c[0] for c in TRAINING])
def test_training_cell_on_meta_has_no_stacked_select_backward(arch_id,
                                                              shape, cut):
    """A training step counted on meta has no ``select_backward`` of a
    stacked weight; the only ones left are equiformer's picks of its
    l = 0 channel from a [N, n_lm, d] activation (as the reference's
    ``x[:, 0, :]``), none in the other families."""
    built = treg.get(arch_id).build(shape, {**_smoke(arch_id), **cut})
    inputs = built.make_inputs("meta", 0)
    stacked = {tuple(p.shape) for p in count._tensors(inputs[0])
               if p.dim() >= 2}
    with _SelectBackwards() as sb:
        _, rec = count.measure(built.fn, inputs, "meta")
    assert not stacked & set(sb.sizes)
    if arch_id == "equiformer-v2":
        n_lm = built.cfg.lm_count
        assert sb.sizes and all(len(s) == 3 and s[1] == n_lm
                                for s in sb.sizes), sb.sizes
    else:
        assert "aten.select_backward.default" not in rec["by_op"]
        assert not sb.sizes


@pytest.mark.parametrize("arch_id", ["gemma3-1b", "gatedgcn"])
def test_weight_gradient_bytes_are_linear_in_depth(arch_id):
    """The counted bytes of a training step on meta are affine in the
    layer count (L 2, 3, 4): the stacked weights' gradients take O(L)
    bytes."""
    shape, cut = {"gemma3-1b": ("train_4k", dict(seq=32, batch=2)),
                  "gatedgcn": ("molecule", {})}[arch_id]
    field = "n_layers"
    got = []
    for n in (2, 3, 4):
        built = treg.get(arch_id).build(shape, {**_smoke(arch_id), **cut,
                                                field: n})
        _, rec = count.measure(built.fn, built.make_inputs("meta", 0),
                               "meta")
        got.append(rec["bytes"])
    assert got[2] - got[1] == got[1] - got[0] > 0
