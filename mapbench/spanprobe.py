#!/usr/bin/env python3
"""The program's span readings in a cell, on the card, beside the outside
clocks: what the traced run will report once its runner records spans
(``mapbench/harness/spanrecords.py``; PERF.md §7).

    python3 mapbench/spanprobe.py --workload <cell> --seed <n> --parts on,off

One process: set-up once, then per part a traced part of the cell's traffic
as the traced run makes one (its first ``runner.TRACE_S`` seconds under a
CUDA-only trace; a service cell: its first two bursts), with the recorder
on or off. Each part prints one JSON line: the eight span readings, the
device's idle share, the host clock's map or traced p95, the spans per
unit, and, with the recorder on, the card's idle time by span.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
READINGS = ("planner.host_ms.direct", "planner.sync_wait_ms.direct",
            "planner.root_level_device_s.direct", "partitioner.enqueue_ms.direct",
            "service.queue_wait_ms", "service.round_host_ms", "service.sync_wait_ms",
            "device.idle_in_rounds.service")


def traced_part(drv, on: bool, first: int) -> tuple[dict, int]:
    """One traced part from request ``first`` on: (its line, requests begun)."""
    import torch
    from mapbench.harness import manifest, records, runner, spanrecords, trace
    from repro_torch.core import spans
    kind = drv.plan.kind
    seconds = runner.TRACE_S if kind == "direct" else runner.TRACE_S + 1.0
    dw = trace.DeviceWindow()
    if on:
        spans.enable()
    dw.start()
    win = drv.window(seconds, first=first, mark=(runner.TRACE_S, dw.stop))
    spans.disable()
    got = spans.drain()
    names, s, e = trace._device_events(dw.prof)
    dw.prof = None
    busy = trace._merged(s, e)   # DeviceWindow.summary's busy time, with its intervals
    tr = {"busy_s": float((busy[1] - busy[0]).sum() / 1e9), "device_ops": len(names),
          "traced_s": dw.t1 - dw.t0, "units": dw.units}
    jobs = win["jobs"]
    rec = {"kind": kind, "trace": tr,
           "latencies": [j.t1 - j.t0 if j.ok else float("inf") for j in jobs]}
    host = [j.t1 - j.t0 for j in jobs[:tr["units"]]]
    line = {"recorder": "on" if on else "off", "units": tr["units"],
            "all_ok": all(j.ok for j in jobs), "traced_s": tr["traced_s"],
            "device_ops": tr["device_ops"],
            f"device.idle.{kind}": records.idle_pct(rec, kind)}
    if kind == "direct":
        line["host_map_s"] = statistics.fmean(host)
    else:
        line["service.job_p95_traced_s"] = records.job_p95_traced_s(rec)
    if on:
        rec["spans"] = sp = spanrecords.traced_part(got, tr["units"], dw.t0, dw.t1, busy)
        line.update({n: manifest.reader(n)(rec) for n in READINGS})
        line["spans_per_unit"] = len(sp["spans"]) / max(tr["units"], 1)
        line["dropped"] = sp["dropped"]
        if kind == "direct":
            maps = [x.t1 - x.t0 for x in sp["spans"] if x.name == "map"]
            line["map_span_s"] = statistics.fmean(maps) / 1e9
        else:
            per = {}
            for x in sp["spans"]:
                if x.name in ("service.queue", "service.finalize"):
                    per.setdefault(x.req, []).append(x.name)
            line["jobs_with_one_queue_and_finalize"] = sum(
                sorted(v) == ["service.finalize", "service.queue"] for v in per.values())
        line["idle_by_span_s"] = spanrecords.idle_by_span(sp, kind, dw.t0, dw.t1, busy)
    torch.cuda.empty_cache()
    return line, len(jobs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--parts", default="on,off", help="comma-separated on/off")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from mapbench.harness import manifest, runner
    from mapbench.harness.drivers import Driver
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    _build.library()
    drv = Driver(manifest.resolve(args.workload), args.seed, 60.0, "cuda")
    drv.make_inputs()
    drv.start()
    drv.warm()
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": runner.card_line(),
                      "setup_s": time.perf_counter() - T_START}), flush=True)
    first = 0
    for part in args.parts.split(","):
        line, begun = traced_part(drv, part == "on", first)
        first += begun
        print(json.dumps(line), flush=True)
    drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
