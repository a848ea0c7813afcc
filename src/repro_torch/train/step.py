"""One LM training step: loss and gradients by autograd, then an optimizer
update on the parameter tree (the body of the reference's jitted
``step_fn`` in ``launch/train.py`` and ``configs/smoke_runners.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import common as MC
from repro_torch.models import transformer as TM


def loss_and_grads(params: MC.ParamTree, batch: Dict[str, torch.Tensor],
                   cfg: TM.TransformerConfig
                   ) -> Tuple[torch.Tensor, MC.ParamTree]:
    """``loss_fn``'s value (detached) and its gradient tree, keyed as
    ``params``; the weights take gradients through a model built on the
    tree's own tensors, which is dropped afterwards."""
    model = TM.Transformer(cfg, params, trainable=True)
    loss = TM.loss_fn(model, batch, cfg)
    loss.backward()
    grads = MC.nest({k: p.grad for k, p in model.named_parameters()})
    return loss.detach(), grads


def lm_train_step(params: MC.ParamTree, ostate: Any,
                  batch: Dict[str, torch.Tensor], cfg: TM.TransformerConfig,
                  update: Callable, ocfg: Any
                  ) -> Tuple[torch.Tensor, MC.ParamTree, Any]:
    """(loss, new params, new optimizer state) after one ``update``
    (``optimizer.adamw_update`` / ``adafactor_update``) with ``ocfg``."""
    loss, grads = loss_and_grads(params, batch, cfg)
    params, ostate = update(grads, ostate, params, ocfg)
    return loss, params, ostate
