"""One run of a cell, from set-up to the result line.

Order: the kernel library, the inputs, the warm-up (set-up ends there), the
window (under a CUDA-only trace with ``--trace 1``), the peak memory, the
traced run's extra passes (roofline, breakdown), the program's state freed,
the check that no JAX module was loaded, then the reference's judgement of
every answer of the window. ``run_cell`` takes the device, so that the CPU
tests drive the same path at a tiny size.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time

import torch

from . import check, manifest, trace
from .drivers import Driver

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # compared as whole top-level names
TRACE_S = 15.0    # the traced run traces the window's first seconds (its reduction
                  # takes about 70 us a device op on the host)
EXTRA_FIRST = 20000   # the extra passes' first request index, beyond any window's


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not available ({exc!r})"


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(cell, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, log=print) -> tuple[dict, int]:
    """Run ``cell`` once; returns ``(result line, exit code)``."""
    from repro_torch.core import multisection as MS
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    on_card = torch.device(device).type == "cuda"
    if on_card:
        _build.library()
    t_lib = time.perf_counter()
    drv = Driver(cell, seed, seconds, device)
    drv.make_inputs()
    t_inputs = time.perf_counter()
    drv.start()
    warm = drv.warm()
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s: imports and library {t_lib - t_start:.3f} s, inputs "
        f"{t_inputs - t_lib:.3f} s, warm-up {t_start + setup_s - t_inputs:.3f} s "
        f"({len(warm)} requests, {sum(not j.ok for j in warm)} failed)")
    MS.reset_transfer_stats()
    _build.reset_launches()
    if traced:
        dw, at_mark = trace.DeviceWindow(), {}

        def mark(units):   # the program's counters over the traced part alone
            dw.stop(units)
            at_mark.update(drv.counters())
        dw.start()
        win = drv.window(seconds, mark=(min(seconds, TRACE_S), mark))
        t0 = time.perf_counter()
        tr = dw.summary()
        log(f"the trace's reduction {time.perf_counter() - t0:.3f} s")
    else:
        win, tr = drv.window(seconds), None
    jobs = win["jobs"]
    peak = torch.cuda.max_memory_allocated(drv.device) if on_card else 0
    svc = at_mark if traced else drv.counters()
    if on_card:
        log(f"card: {card_line()}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
            f"kernel library built in {_build.BUILD_SECONDS:.3f} s (0 = from the cache)")
    log(f"window {win['window_s']:.3f} s (drained {win['drained_s']:.3f} s, arrivals up to "
        f"{win['late_s']:.4f} s late): {len(jobs)} begun, {win['completed']} completed; "
        f"transfers {MS.transfer_stats()}; "
        f"launches {dict(_build.LAUNCHES)}; peak device memory {peak} B; counters {svc}")
    rec = {"kind": drv.plan.kind, "setup_s": setup_s, "window_s": win["window_s"],
           "completed": win["completed"], "counters": svc,
           "latencies": [j.t1 - j.t0 if j.ok else math.inf for j in jobs],
           "levels": [j.levels for j in jobs if j.levels]}
    cost = [j for j in jobs if 0 <= j.i < drv.plan.cost]
    if len(cost) == drv.plan.cost and all(j.ok for j in cost):
        rec["cost_J"] = math.fsum(j.J for j in cost) / len(cost)
    extra = {}
    if traced:
        rec["trace"] = tr
        log(f"traced {tr['traced_s']:.3f} s: {tr['units']} answered, "
            f"{tr['traced_s'] / max(tr['units'], 1):.4f} s each, device busy "
            f"{tr['busy_s']:.3f} s, {tr['device_ops']} device ops; kernels {tr['kernels']}")
        extra_s = drv.extra_s
        t0 = time.perf_counter()
        rec["roofline"] = trace.roofline_pass(
            lambda: drv.window(extra_s, first=EXTRA_FIRST), kops)
        t1 = time.perf_counter()
        log(f"roofline pass ({t1 - t0:.3f} s): {rec['roofline']}")
        extra["breakdown"] = trace.breakdown_pass(
            lambda: drv.window(extra_s, first=2 * EXTRA_FIRST))
        log(f"breakdown pass {time.perf_counter() - t1:.3f} s")
    drv.close()
    drv.tgs = []   # the program's graphs on the device: the reference reads only edges
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}", file=sys.stderr)
        return {}, 3
    t0 = time.perf_counter()
    checks, failed = check.judge(drv, jobs, cell.config["limits"])
    log(f"reference check of {len(jobs)} answers {time.perf_counter() - t0:.3f} s")
    del drv
    correct = check.passes(checks) and failed == 0 and "cost_J" in rec
    metrics = manifest.read_metrics(cell.per_layer if traced else cell.end_to_end, rec,
                                    required=not traced and correct)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        device_info.update(busy_s=tr["busy_s"], window_s=tr["traced_s"])
    line = {"correct": bool(correct), "attempted": len(jobs), "failed": int(failed),
            "metrics": metrics, "device": device_info, **extra,
            "checks": {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                       for k, c in checks.items()}}
    return line, 0
