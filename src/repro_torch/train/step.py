"""One training step for any model of the port: loss and gradients by
autograd, then an optimizer update on the parameter tree (the body of the
reference's jitted ``step_fn`` in ``launch/train.py`` and of the train
steps in ``configs/smoke_runners.py``).

A model family comes in as its module class (a ``common.TreeModel``) and
its ``loss_fn(model, batch, cfg)``; the defaults are the LM's."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import common as MC
from repro_torch.models import transformer as TM


def loss_and_grads(params: MC.ParamTree, batch: Dict[str, Any], cfg: Any,
                   *, model_cls: type = TM.Transformer,
                   loss_fn: Callable = TM.loss_fn
                   ) -> Tuple[torch.Tensor, MC.ParamTree]:
    """``loss_fn``'s value (detached) and its gradient tree, keyed as
    ``params``; the weights take gradients through a ``model_cls`` built on
    the tree's own tensors, which is dropped afterwards."""
    model = model_cls(cfg, params, trainable=True)
    loss = loss_fn(model, batch, cfg)
    loss.backward()
    grads = MC.nest({k: p.grad for k, p in model.named_parameters()})
    return loss.detach(), grads


def train_step(params: MC.ParamTree, ostate: Any, batch: Dict[str, Any],
               cfg: Any, update: Callable, ocfg: Any, *,
               model_cls: type = TM.Transformer,
               loss_fn: Callable = TM.loss_fn
               ) -> Tuple[torch.Tensor, MC.ParamTree, Any]:
    """(loss, new params, new optimizer state) after one ``update``
    (``optimizer.adamw_update`` / ``adafactor_update``) with ``ocfg``."""
    loss, grads = loss_and_grads(params, batch, cfg, model_cls=model_cls,
                                 loss_fn=loss_fn)
    params, ostate = update(grads, ostate, params, ocfg)
    return loss, params, ostate
