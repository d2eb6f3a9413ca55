#!/usr/bin/env python3
"""Times this checkout's serving and training paths against an earlier
checkout's, in turns, on one NVIDIA GPU.

    python3 chip_path_ab.py --old OLD_CHECKOUT

``OLD_CHECKOUT`` is the root of an earlier checkout of this repository, for
example the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists. Each turn starts a process of its own in one
checkout's root and runs that checkout's ``chip_smoke.py`` phase 10
(``_serving_path``: llama3.2-3b's flash and ``_sdpa`` prefill at 4 x 4096,
the Engine's 4 prompts x 64 steps, a profile of the prefill) and phase 12
(d) (``_train_full``: llama3.2-3b's train step at B 1 x S 2048 under remat
full and dots, and none beside full at 14 layers). The turns go old, new,
new, old, and the lines that carry times are printed, tagged by checkout
and turn. ``chip_smoke.py`` checks the values; this script compares times
only, and wall times differ between hosts, so both checkouts run in one
call.

It exits with code 2 without a CUDA device. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIMED = ("prefill_fn llama3.2-3b B=4", "engine llama3.2-3b", "profile:",
         "train step at full width")
TURN = r'''
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke as C
from repro_torch.kernels import _build
_build.library()
dev = torch.device("cuda")
C._serving_path(dev, lambda *args, **kwargs: None, _build)
torch.cuda.empty_cache()
C._train_full(dev)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="root of the earlier checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_path_ab: no CUDA device is available", file=sys.stderr)
        return 2
    trees = {"old": Path(args.old).resolve(), "new": ROOT}
    for turn, side in enumerate(("old", "new", "new", "old"), 1):
        p = subprocess.run([sys.executable, "-c", TURN], cwd=trees[side], capture_output=True,
                           text=True)
        if p.returncode:
            print(f"[{side} {turn}] exited {p.returncode}:\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
            return 1
        for line in p.stdout.splitlines():
            if any(k in line for k in TIMED):
                print(f"[{side} {turn}] {line[:320]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
