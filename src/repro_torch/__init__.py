"""repro_torch: the PyTorch/CUDA port of the distributed MWIS reductions.

A second package beside the JAX reference ``repro``: the same modules under
the same names, written over torch tensors, with each of the reference's
four TPU kernels replaced by a hand-written CUDA kernel for Hopper — the
fused int32 segment reduction on the solver's main path
(``kernels/segment_coo``), and behind their public ops the float segment
sum (``kernels/segment_coo``), the per-edge window intersection
(``kernels/wedge_intersect``) and the sum-mode EmbeddingBag
(``kernels/embedding_bag``).

Entry points take ``device=`` and default to ``"cuda"``.  Without a visible
GPU they raise instead of running on the CPU; the tests pass
``device="cpu"``, where every kernel wrapper takes its plain torch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless asked otherwise.

    Raises if CUDA is asked for (explicitly or by default) and no GPU is
    visible — the port never moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (--device cpu) "
            "to run the port on the CPU"
        )
    return dev
