"""Time the model paths of two trees in turn on one card: A, B, B, A, ...

    python tools/model_paths_ab.py TREE_A TREE_B [--rounds 2]

Each run is a fresh process that imports ``chip_smoke.py`` from its tree
(with that tree's ``src`` first on the path), builds the tree's kernels and
runs ``chip_smoke.py``'s own measurements of the paths the models take:
DLRM serving at its widths through the kernel and the plain lookup
(``dlrm_at_width``, phase 18), gemma3-1b decode at full width
(``lm_decode_at_width``, phase 18), gemma3-1b training at full width
(``lm_train_at_width``, phase 19) and DLRM training at its widths
(``dlrm_train_at_width``, phase 20).  Each run's lines are printed
prefixed with its tree's label and round; the card's name and power limit
come first.  Two versions are compared only within one call: the order
A, B, B, A cancels a drift of the host clock over the call.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CHILD = """
import argparse, subprocess, sys, time
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as S
from repro_torch import kernels
from repro_torch.kernels.embedding_bag import kernel as EK
from repro_torch.kernels.segment_coo import kernel as K
from repro_torch.kernels.wedge_intersect import kernel as WK
smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                      "--format=csv,noheader,nounits"], capture_output=True,
                     text=True, check=True).stdout.split()[0]
S.CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
S.CARD["max_sm_hz"] = float(smi) * 1e6
kernels.build_many(list({**K.LIBS, **WK.LIBS, **EK.LIBS}.values()))
dev = torch.device("cuda")
opts = argparse.Namespace(seed=0, reps=20)
for part in (S.dlrm_at_width, S.lm_decode_at_width, S.lm_train_at_width,
             S.dlrm_train_at_width):
    t = time.time()
    part(dev, opts)
    torch.cuda.empty_cache()
    print(f"[ab] {part.__name__} seconds={time.time() - t:.1f}", flush=True)
"""

#: Lines of a run worth comparing (the rest are profiles and set-up).
KEEP = ("dlrm kernel:", "dlrm plain lookup:", "decode B=", "train B=",
        "[ab] ")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--rounds", type=int, default=2,
                    help="A, B, B, A pairs (each round runs both trees)")
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    trees = {"A": str(Path(args.tree_a).resolve()),
             "B": str(Path(args.tree_b).resolve())}
    order = []
    for r in range(args.rounds):
        order += ["A", "B"] if r % 2 == 0 else ["B", "A"]
    for i, label in enumerate(order):
        res = subprocess.run([sys.executable, "-c", CHILD, trees[label]],
                             capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"run {i} ({label}, {trees[label]}) failed:\n"
                     f"{res.stderr[-3000:]}")
        for line in res.stdout.splitlines():
            if any(k in line for k in KEEP):
                print(f"{label}{i} {line[:400]}", flush=True)


if __name__ == "__main__":
    main()
