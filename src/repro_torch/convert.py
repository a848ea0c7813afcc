"""Carry solver state and model weights across from the JAX reference.

The MWIS solver has no weights; its counterpart is the solver state.  These
functions turn the reference's NamedTuples (``UnionProblem``, ``Aux``,
``Halo``, ``SegPlan``, ``RedState``), read field by field as numpy arrays,
into the port's tensors on a chosen device — so a test can start both
implementations from one mid-solve state.  :func:`params` turns a model's
parameter tree (nested dicts of arrays) into the port's state dict, and
:func:`opt_state` an optimizer state into the port's.
Nothing here imports the reference: any object with the same field names
will do.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core import engine as E
from repro_torch.core import exchange as X
from repro_torch.core import rules as R


def tensor(a, device: torch.device | str = "cpu") -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` reads) → tensor, same
    dtype and shape."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params(tree, device: torch.device | str = "cpu") -> dict:
    """A nested dict of arrays (the reference's parameter tree) → a state
    dict keyed by the tree's paths joined with ``.`` (``attn.wq``), for
    ``load_state_dict(..., strict=True)``.  bfloat16 arrays (``ml_dtypes``,
    which ``torch.from_numpy`` refuses) cross as their ``uint16`` bits."""
    out = {}
    _params_into(out, tree, "", device)
    return out


def _params_into(out: dict, t, prefix: str, device) -> None:
    # not a recursive closure: that would be a reference cycle keeping
    # ``out`` alive until the cyclic collector ran
    for k, v in t.items():
        if isinstance(v, dict):
            _params_into(out, v, f"{prefix}{k}.", device)
            continue
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            out[prefix + k] = torch.from_numpy(
                a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
        else:
            out[prefix + k] = tensor(a, device)


def opt_state(src, device: torch.device | str = "cpu"):
    """The reference's ``AdamWState`` / ``AdafactorState`` (told apart by
    their fields) → the port's: each moment tree through :func:`params`
    and nested again, the step an int32 scalar tensor."""
    from repro_torch.models.common import nest
    from repro_torch.train import optimizer as opt

    cls = opt.AdamWState if hasattr(src, "mu") else opt.AdafactorState
    step = torch.tensor(int(np.asarray(src.step)), dtype=torch.int32,
                        device=device)
    return cls(step, *(nest(params(getattr(src, f), device))
                       for f in cls._fields[1:]))


def _fields(cls, src, device):
    return cls(**{f: tensor(getattr(src, f), device) for f in cls._fields})


def aux(src, device: torch.device | str = "cpu") -> R.Aux:
    return _fields(R.Aux, src, device)


def red_state(src, device: torch.device | str = "cpu") -> R.RedState:
    return _fields(R.RedState, src, device)


def halo(src, device: torch.device | str = "cpu") -> X.Halo:
    return _fields(X.Halo, src, device)


def seg_plan(src, device: torch.device | str = "cpu") -> E.SegPlan:
    """The reference carries the row-block height as the leading dimension
    of a zero-size ``rblk_tpl`` array; the port keeps it as an int.  The
    live extents, which the reference has no field for, are derived from
    ``lrow``."""
    def opt(a):
        return None if a is None else tensor(a, device)

    lrow = tensor(src.lrow, device)
    r_blk = int(np.shape(src.rblk_tpl)[0])
    return E.SegPlan(
        edge_perm=tensor(src.edge_perm, device), lrow=lrow, r_blk=r_blk,
        wbits=opt(src.wbits), wnh=opt(src.wnh),
        extent=E.live_extent(lrow, r_blk),
    )


def union_problem(src, device: torch.device | str = "cpu") -> D.UnionProblem:
    return D.UnionProblem(
        w0=tensor(src.w0, device),
        is_local=tensor(src.is_local, device),
        is_ghost=tensor(src.is_ghost, device),
        aux=aux(src.aux, device),
        halo=halo(src.halo, device),
        p=int(src.p), V=int(src.V),
        plan=None if src.plan is None else seg_plan(src.plan, device),
    )


def to_numpy(nt) -> dict:
    """A NamedTuple of tensors (or arrays) → {field: numpy array}, for
    comparing the two implementations field by field."""
    out = {}
    for f in nt._fields:
        v = getattr(nt, f)
        if torch.is_tensor(v):
            v = v.cpu().numpy()
        out[f] = v if isinstance(v, (int, type(None))) else np.asarray(v)
    return out
