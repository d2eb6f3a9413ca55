#!/usr/bin/env python3
"""The highest arrival rate a service cell's configuration sustains, found
once by a sweep on the card (a cell's rate is then fixed in its traffic
file; the benchmark's runs never search for one).

    python3 mapbench/sweep.py --workload <service cell> --rates 3,4,6,8 --seconds 30

One process: set-up once, then per rate a window of the cell's traffic at
that rate, reporting the jobs answered per second, the backlog left at the
close (requests begun and not yet answered), and the median and 95th
percentile latency from each request's due time.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated, jobs per second")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from mapbench.harness import manifest, records
    from mapbench.harness.drivers import Driver
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    base = manifest.resolve(args.workload)
    inputs = None
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell.traffic["rate"] = rate
        drv = Driver(cell, args.seed, args.seconds, "cuda")
        if inputs is None:
            drv.make_inputs()
            inputs = (drv.edges, drv.tgs)
        drv.edges, drv.tgs = inputs
        drv.start()
        if k == 0:
            drv.warm()
        t0 = time.perf_counter()
        win = drv.window(args.seconds)
        jobs = win["jobs"]
        end = t0 + args.seconds
        lat = [j.t1 - j.t0 for j in jobs]
        print(json.dumps({
            "rate": rate, "offered": len(jobs), "answered_per_s": win["completed"] / args.seconds,
            "backlog_at_close": sum(j.t1 > end for j in jobs), "drained_s": win["drained_s"],
            "p50_s": records.percentile(lat, 50), "p95_s": records.percentile(lat, 95),
            "late_s": win["late_s"], "failed": sum(not j.ok for j in jobs),
            "service": drv.counters().get("coalesce")}), flush=True)
        drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
