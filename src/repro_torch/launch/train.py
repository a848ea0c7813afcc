"""Training entry point of the port: any LM arch at its reduced (SMOKE)
config, on a card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --steps 100 --ckpt build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --steps 20 --device cpu

The port of ``repro.launch.train``: the same flags (``--arch``,
``--steps``, ``--batch``, ``--seq``, ``--ckpt``, ``--save-every``), the
same SMOKE configs with ``loss_chunks=2``, AdamW at lr 3e-4, batches
``data.pipeline.lm_batch`` by step, and the loop under
``TrainSupervisor`` (checkpoint cadence, restart-resume, straggler
flags), with the reference's printed lines.  Plus ``--device`` (default
cuda; without a visible GPU it exits unless ``--device cpu`` is given)
and ``--seed`` (the weights, from a ``torch.Generator`` on the device).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import gemma3_1b, grok1_314b, mistral_nemo_12b
from repro_torch.configs import qwen3_32b, qwen3_moe_235b
from repro_torch.data.pipeline import LMBatchSpec, lm_batch
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import TrainSupervisor
from repro_torch.models import common as MC
from repro_torch.models import transformer as TM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import train_step

#: The LM archs' reduced configs, as the reference's ``smokes`` map.
SMOKES = {
    "gemma3-1b": gemma3_1b.SMOKE,
    "qwen3-32b": qwen3_32b.SMOKE,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.SMOKE,
    "grok-1-314b": grok1_314b.SMOKE,
    "mistral-nemo-12b": mistral_nemo_12b.SMOKE,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b", choices=tuple(SMOKES),
                    help="an LM arch (train.py drives the LM family)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="device type it trains on (cuda | cpu)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """Train; returns the printed losses by step, the supervisor's events
    and the final state."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(SMOKES[args.arch], loss_chunks=2)
    print(f"training {cfg.name} (reduced): {cfg.n_params() / 1e6:.2f}M "
          f"params")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = MC.init_params(TM.param_specs(cfg), gen, dev)
    ostate = opt.adamw_init(params)
    ocfg = opt.AdamWConfig(lr=3e-4)
    bspec = LMBatchSpec(args.batch, args.seq, cfg.vocab)

    cm = CheckpointManager(args.ckpt, keep=2)
    sup = TrainSupervisor(cm, save_every=args.save_every)
    losses = {}

    def one(state, step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in lm_batch(bspec, step).items()}
        loss, p2, o2 = train_step(state["params"], state["opt"], batch,
                                  cfg, opt.adamw_update, ocfg)
        if step % 10 == 0:
            losses[step] = float(loss)
            print(f"step {step}: loss={losses[step]:.4f}", flush=True)
        return {"params": p2, "opt": o2}

    state = {"params": params, "opt": ostate}
    t0 = time.time()
    state = sup.run(state, one, args.steps, state_template=state)
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s; "
          f"events={sup.events}")
    return dict(losses=losses, events=sup.events, state=state)


if __name__ == "__main__":
    main()
