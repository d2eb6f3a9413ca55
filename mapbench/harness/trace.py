"""Device traces: what the profiler saw the card do, reduced in memory to
the few numbers the per-layer metrics read. Nothing is written to disk.

* :class:`DeviceWindow` -- a CUDA-only activity trace (no CPU activity, so
  the profiler's host overhead does not stretch the window) of the first
  seconds of the timed window: busy seconds (the union of device
  intervals), device ops, and device ms by kernel group.
* :func:`roofline_pass` -- one more pass of the cell's work with the five
  mapping kernels' routes wrapped to count each launch's bytes and
  operations (:mod:`bound`), under a CUDA-only trace: the kernels' summed
  least time over their summed device time.
* :func:`breakdown_pass` -- one more pass with CPU activity on: the device
  ops that took most time, and the longest idle gaps of the card by the
  innermost host op running in them.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from . import bound

# Kernel groups the metrics read: a group's device ms is the sum over the
# device ops whose name contains any of its patterns (compared in lower case).
KERNEL_GROUPS = {
    "scan": ("scan",),
    "lp_gain": ("lp_gain_kernel",),
    "hem_propose": ("hem_propose_kernel",),
    "contract_edges": ("contract_edges_kernel",),
    "gather_rows": ("gather_rows_kernel",),
    "mapcost": ("mapcost_kernel",),
}
MAPPING_KERNELS = ("lp_gain", "hem_propose", "contract_edges", "gather_rows", "mapcost")
NAME_CHARS = 120   # a kernel's name as the breakdown gives it


def _device_events(prof):
    """(names, start_ns, end_ns) of the ops the card ran, in start order."""
    cuda = torch.autograd.DeviceType.CUDA
    names, starts, durs = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            names.append(e.name())
            starts.append(e.start_ns())
            durs.append(e.duration_ns())
    s = np.asarray(starts, np.int64)
    order = np.argsort(s, kind="stable")
    return [names[i] for i in order], s[order], (s + np.asarray(durs, np.int64))[order]


def _merged(starts, ends):
    """The union of [start, end) intervals sorted by start: (starts, ends)."""
    if not len(starts):
        return starts, ends
    reach = np.maximum.accumulate(ends)
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > reach[:-1]
    idx = np.nonzero(new)[0]
    last = np.append(idx[1:] - 1, len(starts) - 1)
    return starts[idx], reach[last]


def group_ms(names, starts, ends) -> dict:
    """``{group: {"ms", "count"}}`` over the device ops of each kernel group."""
    ns, count = collections.Counter(), collections.Counter()
    for n, d in zip(names, (ends - starts).tolist()):
        ns[n] += d
        count[n] += 1
    out = {}
    for group, pats in KERNEL_GROUPS.items():
        hit = [n for n in ns if any(p in n.lower() for p in pats)]
        out[group] = {"ms": sum(ns[n] for n in hit) / 1e6, "count": sum(count[n] for n in hit)}
    return out


class DeviceWindow:
    """A CUDA-only trace from :meth:`start` to :meth:`stop` (called from the
    thread that started it), reduced by :meth:`summary`."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0.0
        self.units = 0

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        """End the trace; ``units`` maps or jobs were answered inside it."""
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.units = units

    def summary(self) -> dict:
        names, s, e = _device_events(self.prof)
        self.prof = None
        ms, me = _merged(s, e)
        return {"busy_s": float((me - ms).sum() / 1e9), "device_ops": len(names),
                "traced_s": self.t1 - self.t0, "units": self.units,
                "kernels": group_ms(names, s, e)}


class _Counter:
    """Wraps ``kernels.ops``' mapping routes; each call's bytes and
    operations are kept (as 0-dim tensors where they depend on the data)."""

    def __init__(self, kops):
        self.kops = kops
        self.saved = {k: getattr(kops, k) for k in MAPPING_KERNELS}
        self.calls = {k: [] for k in MAPPING_KERNELS}

    def __enter__(self):
        for name, orig in self.saved.items():
            setattr(self.kops, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        count = bound.COUNTS[name]

        def counted(*args):
            self.calls[name].append(count(*args))
            return orig(*args)
        return counted

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            setattr(self.kops, name, orig)

    def bounds_ms(self) -> dict:
        return {k: sum(bound.bound_ms(float(b), float(o)) for b, o in v)
                for k, v in self.calls.items()}


def roofline_pass(run, kops):
    """Run ``run()`` once with the mapping kernels counted, under a CUDA-only
    trace: per kernel its launches, bound ms and device ms."""
    with _Counter(kops) as counter:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    names, s, e = _device_events(prof)
    del prof
    device = group_ms(names, s, e)
    bounds = counter.bounds_ms()
    return {k: {"launches": len(counter.calls[k]), "kernels": device[k]["count"],
                "bound_ms": bounds[k], "device_ms": device[k]["ms"]}
            for k in MAPPING_KERNELS}


def breakdown_pass(run, top: int = 10):
    """Run ``run()`` once under a CPU and CUDA trace: the ``top`` device ops
    by device seconds, and the card's idle gaps summed by the innermost host
    op that was running at each gap's middle."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    host = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda and ev.duration_ns() > 0:
            host.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    names, s, e = _device_events(prof)
    del prof
    by_op = collections.Counter()
    for n, d in zip(names, (e - s) / 1e9):
        by_op[n[:NAME_CHARS]] += float(d)
    ms, me = _merged(s, e)
    gaps = collections.Counter()
    if len(ms) > 1:
        host.sort()
        hs = np.asarray([h[0] for h in host], np.int64)
        for a, b in zip(me[:-1], ms[1:]):
            gaps[_innermost(host, hs, (a + b) // 2)] += float((b - a) / 1e9)
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}


def _innermost(host, starts, t, look_back: int = 256) -> str:
    """The name of the latest-starting host op that covers time ``t``."""
    i = int(np.searchsorted(starts, t, "right")) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(no op on the host)"
