#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card.

    python3 mapbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds <s>

In one process (set-up once, then a short window per seed, at the cell's
own sizes and load) it judges every answer of each window twice: as the
program gave it (the lower readings: sound runs) and with the control in
the program's place, the reference's J computed in bfloat16 (the upper
readings). The benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, seconds: float, device: str, log=print) -> dict:
    """Per seed the program's and the control's numbers, and the lower
    (largest of the program's) and upper (least of the control's) readings."""
    from mapbench.harness import check
    from mapbench.harness.drivers import Driver
    inputs = {}
    rows = []
    for k, seed in enumerate(seeds):
        drv = Driver(cell, seed, seconds, device)
        key = tuple(drv.plan.graphs)
        if key not in inputs:
            drv.make_inputs()
            inputs[key] = (drv.edges, drv.tgs)
        drv.edges, drv.tgs = inputs[key]
        drv.start()
        if k == 0:
            drv.warm()
        jobs = drv.window(seconds)["jobs"]
        drv.close()
        limits = cell.config["limits"]
        program, failed = check.judge(drv, jobs, limits)
        control, _ = check.judge(drv, jobs, limits, j_of=check.bf16_J)
        row = {"seed": seed, "answers": len(jobs), "failed": failed,
               "program": {n: c["value"] for n, c in program.items()},
               "control": {n: c["value"] for n, c in control.items()}}
        log(json.dumps(row))
        rows.append(row)
    names = rows[0]["program"]
    return {"rows": rows,
            "lower": {n: max(r["program"][n] for r in rows) for n in names},
            "upper": {n: min(r["control"][n] for r in rows) for n in names}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from mapbench.harness import manifest
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.resolve(args.workload)
    t0 = time.perf_counter()
    out = readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds, "cuda",
                   log=lambda s: print(s, flush=True))
    print(json.dumps({"workload": args.workload, "lower": out["lower"], "upper": out["upper"],
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
