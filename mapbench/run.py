#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 mapbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``mapbench/``
and ``src/``. The cell's configuration, traffic and metrics are found by
name from ``BENCHMARK.json`` (``mapbench/harness/manifest.py``). Earlier
lines report the card, set-up and the window; the last line of standard
output is the result as one JSON object, and the last lines of standard
error give each number compared beside its limit. Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / ".mapbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from mapbench.harness import manifest, runner
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only", file=sys.stderr)
        return 2
    cell = manifest.resolve(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} "
              "present", file=sys.stderr)
        return 2
    line, rc = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                               T_START, log=lambda s: print(s, flush=True))
    if rc:
        return rc
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
