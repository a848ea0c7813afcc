"""Checkpointing with integrity manifests + async commit.

Port of :mod:`repro.distributed.checkpoint` over torch tensors.  Format
(directory per step):

    step_000123/
      manifest.json      — tree structure, shapes, dtypes, leaf files,
                           content hashes, caller metadata (``extra``)
      <leafpath>.npy     — one file per tree leaf (the whole array)

Fault-tolerance properties:

  * atomic commit — written to ``<dir>.tmp`` then renamed; a crash mid-write
    never corrupts the latest checkpoint (restore scans for the newest
    *committed* step),
  * integrity — SHA256 per leaf, verified on restore,
  * async mode  — every leaf is copied to host memory before ``save``
    returns (a CUDA tensor's copy waits for the kernels that write it), and
    only the disk write runs on a background thread, so the caller may
    go on updating its tensors in place (``wait()`` joins before the next
    save),
  * device restore — leaves are saved as plain arrays; ``restore``
    gives a tensor where the template has one (on ``device=`` when given,
    else on the template leaf's device, in its dtype) and a numpy array
    where the template has an array,
  * bfloat16 — a bfloat16 tensor (every LM weight) is saved as its
    ``uint16`` bits, ``"dtype": "bfloat16"`` in the manifest and the hash
    over those bits, and comes back as a bfloat16 tensor (numpy has no
    bfloat16 without ``ml_dtypes``).

A tree is a nest of dicts, lists/tuples and NamedTuples over tensors or
arrays; NamedTuple leaves are keyed by field name, so a restored
``RedState`` comes back field for field.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _leaf_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_leaf_paths(tree[k], f"{prefix}{k}."))
    elif hasattr(tree, "_fields"):  # NamedTuple — before the tuple branch,
        # so leaf keys are field names (what _unflatten_like looks up)
        for k in tree._fields:
            out.update(_leaf_paths(getattr(tree, k), f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaf_paths(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


_BF16 = "bfloat16"


def _host_copy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(a host array the caller can no longer change, its manifest dtype):
    a tensor is copied off its device (or, on the CPU, cloned), a bfloat16
    one as its ``uint16`` bits; an array is copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like: Any,
               device: torch.device | str | None) -> Any:
    """A restored leaf in the template leaf's kind: a tensor (on
    ``device``, else on ``like``'s device, in ``like``'s dtype) where
    ``like`` is a tensor, else the array (bfloat16 as its ``uint16``
    bits)."""
    if not isinstance(like, torch.Tensor):
        return arr
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device if device is not None else like.device,
                dtype=like.dtype)


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- #
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        self.wait()
        host = {k: _host_copy(v) for k, v in _leaf_paths(tree).items()}

        def write():
            tmp = os.path.join(self.root, f"step_{step:09d}.tmp")
            final = os.path.join(self.root, f"step_{step:09d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {
                "step": step, "extra": extra or {}, "leaves": {},
            }
            for k, (arr, dtype) in host.items():
                fn = k.replace("/", "_") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"][k] = {
                    "file": fn,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return os.path.join(self.root, f"step_{step:09d}")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- #
    def list_steps(self):
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, _MANIFEST)):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> str:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint found in {self.root}")
        return os.path.join(self.root, f"step_{step:09d}")

    def manifest(self, step: Optional[int] = None) -> Dict:
        """The committed manifest for `step` (default: latest).

        Exposes ``extra`` metadata without touching array files — restore
        flows whose *templates* depend on saved metadata (e.g. the staged
        solver's per-descent-level state shapes) read this first, build
        shape-correct templates, then call :meth:`restore`.
        """
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)

    def restore(
        self, template: Any, step: Optional[int] = None, *,
        device: torch.device | str | None = None, verify: bool = True,
    ) -> Any:
        """Restore into the structure of `template`: a tensor where the
        template leaf is a tensor (on ``device`` when one is given, else on
        that leaf's device; in its dtype), a numpy array where it is an
        array."""
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        out: Dict[str, Any] = {}
        for k, like in _leaf_paths(template).items():
            meta = manifest["leaves"][k]
            arr = np.load(os.path.join(d, meta["file"]))
            if verify:
                h = hashlib.sha256(arr.tobytes()).hexdigest()
                if h != meta["sha256"]:
                    raise IOError(f"checkpoint leaf {k} failed integrity check")
            out[k] = _from_host(arr, meta["dtype"], like, device)
        return _unflatten_like(template, out)


def _unflatten_like(template: Any, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {
            k: _unflatten_like(template[k], flat, f"{prefix}{k}.")
            for k in template
        }
    if isinstance(template, (list, tuple)) and not hasattr(template, "_fields"):
        t = type(template)
        return t(
            _unflatten_like(v, flat, f"{prefix}{i}.")
            for i, v in enumerate(template)
        )
    if hasattr(template, "_fields"):
        vals = {
            k: _unflatten_like(getattr(template, k), flat, f"{prefix}{k}.")
            for k in template._fields
        }
        return type(template)(**vals)
    return flat[prefix[:-1]]
