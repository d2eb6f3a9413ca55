"""The program's host spans (``repro_torch.core.spans``) in a traced run, and
the arithmetic the span readers (``mapbench/metrics/<name>.py``) apply to
them.

:func:`traced_part` makes ``rec["spans"]`` from the spans begun in the traced
part: ``spans`` (each moved onto the profiler's clock, ``time.time_ns()``),
``summary`` (count, total and self ns by name), ``units`` (the maps or jobs
answered in the traced part), ``dropped`` (spans the recorder lost), and,
given the card's busy intervals, ``rounds_s`` and ``rounds_busy_s``: the
union of the service's rounds inside the traced part, and the card's busy
time inside that union. :func:`idle_by_span` puts the traced part's idle
time down to the program's spans, for the traced run's log.

The runner does not record spans yet (PERF.md §7 lists what it takes), so
until ``rec["spans"]`` is there each reader returns None, as it does in a
cell of another kind. :mod:`mapbench.spanprobe` drives a cell with the
recorder on and prints every reading.
"""
from __future__ import annotations

import collections

import numpy as np

# Spans the program records with ``spans.record``: their ends lie in
# different calls, so they have no parent and are nobody's parent.
RECORDED = ("service.queue", "planner.level")
# The span that a kind's loop thread runs its work under.
LOOP = {"direct": "map", "service": "service.round"}


def traced_part(recs, units: int, t0_s: float, t1_s: float, busy=None) -> dict:
    """``rec["spans"]`` from the recorder's spans ``recs``; the traced part
    ran from ``t0_s`` to ``t1_s`` on ``time.perf_counter()``; ``busy``:
    the card's merged busy intervals ``(starts, ends)`` on the profiler's
    clock, or None off the card."""
    from repro_torch.core import spans
    off = spans.clock_offset_ns()
    w0, w1 = int(t0_s * 1e9) + off, int(t1_s * 1e9) + off
    mine = [s._replace(t0=s.t0 + off, t1=s.t1 + off) for s in recs if s.t0 + off < w1]
    out = {"spans": mine, "summary": spans.summary(mine), "units": int(units),
           "dropped": spans.dropped()}
    if busy is not None:
        rounds = union([(s.t0, s.t1) for s in mine if s.name == "service.round"], w0, w1)
        out["rounds_s"] = sum(b - a for a, b in rounds) / 1e9
        out["rounds_busy_s"] = busy_within(*busy, rounds) / 1e9
    return out


def union(intervals, w0: int, w1: int) -> list[tuple[int, int]]:
    """The union of ``[a, b)`` intervals clipped to ``[w0, w1)``, sorted."""
    out: list[list[int]] = []
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_within(starts, ends, intervals) -> int:
    """Ns of the merged busy intervals ``(starts, ends)`` that fall inside
    the disjoint ``intervals``."""
    if not len(starts) or not intervals:
        return 0
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    before = np.concatenate([[0], np.cumsum(ends - starts)])

    def busy_to(t):   # busy ns before t
        i = np.searchsorted(starts, t, "right")
        return before[i] - np.clip(ends[i - 1] - t, 0, None) if i else 0
    return int(sum(busy_to(b) - busy_to(a) for a, b in intervals))


def _part(rec, kind):
    sp = rec.get("spans")
    if rec["kind"] != kind or not sp or not sp["units"]:
        return None
    return sp


def _total_ms(sp, name) -> float:
    return sp["summary"].get(name, {}).get("total_ns", 0) / 1e6


def _inside(recs, name) -> set[int]:
    """Ids of the spans that run under a span called ``name``."""
    by = {s.id: s for s in recs}
    out = set()
    for s in recs:
        p = by.get(s.parent)
        while p is not None and p.name != name:
            p = by.get(p.parent)
        if p is not None:
            out.add(s.id)
    return out


def _loop_thread(recs, kind):
    threads = collections.Counter(s.thread for s in recs if s.name == LOOP[kind])
    return threads.most_common(1)[0][0] if threads else None


def planner_host_ms(rec):
    """The planner's own host ms a map: the self time of its spans, less
    ``planner.sync`` (the card's) and ``planner.level`` (recorded over the
    others)."""
    sp = _part(rec, "direct")
    if sp is None:
        return None
    ns = sum(v["self_ns"] for n, v in sp["summary"].items()
             if n.startswith("planner.") and n not in ("planner.sync", "planner.level"))
    return ns / 1e6 / sp["units"]


def planner_sync_wait_ms(rec):
    """Ms a map the host waits on the planner's device-to-host fetches."""
    sp = _part(rec, "direct")
    return None if sp is None else _total_ms(sp, "planner.sync") / sp["units"]


def root_level_device_s(rec):
    """The card's seconds in each map's first level (its ``device_ns``), the
    mean over the maps."""
    sp = _part(rec, "direct")
    if sp is None:
        return None
    dev = [s.attrs["device_ns"] for s in sp["spans"]
           if s.name == "planner.level" and s.attrs.get("level") == 0
           and "device_ns" in s.attrs]
    return float(np.mean(dev)) / 1e9 if dev else None


def partitioner_enqueue_ms(rec):
    """Ms a map the host spends issuing the v-cycle (``partitioner.batch``)."""
    sp = _part(rec, "direct")
    return None if sp is None else _total_ms(sp, "partitioner.batch") / sp["units"]


def queue_wait_ms(rec):
    """A job's mean wait from its submit to its admission."""
    sp = _part(rec, "service")
    if sp is None or "service.queue" not in sp["summary"]:
        return None
    q = sp["summary"]["service.queue"]
    return q["total_ns"] / 1e6 / q["count"]


def round_host_ms(rec):
    """Ms a job of the service's rounds, less the planner's fetches in them."""
    sp = _part(rec, "service")
    if sp is None:
        return None
    inside = _inside(sp["spans"], "service.round")
    sync = sum(s.t1 - s.t0 for s in sp["spans"] if s.name == "planner.sync" and s.id in inside)
    return (_total_ms(sp, "service.round") - sync / 1e6) / sp["units"]


def sync_wait_ms(rec):
    """Ms a job the scheduler thread waits on the planner's fetches, the
    admission's scalar fetch included."""
    sp = _part(rec, "service")
    if sp is None:
        return None
    loop = _loop_thread(sp["spans"], "service")
    ns = sum(s.t1 - s.t0 for s in sp["spans"] if s.name == "planner.sync" and s.thread == loop)
    return ns / 1e6 / sp["units"]


def idle_in_rounds_pct(rec):
    """Share of the union of the service's rounds with nothing on the card, %."""
    sp = _part(rec, "service")
    if sp is None or not sp.get("rounds_s"):
        return None
    return 100.0 * (1.0 - sp["rounds_busy_s"] / sp["rounds_s"])


def idle_by_span(sp, kind, t0_s, t1_s, busy) -> dict:
    """The traced part's idle seconds on the card, each put down to the
    innermost span open on the loop thread (the thread of ``LOOP[kind]``):
    ``{"in <loop span>": {name: s}, "elsewhere": {name: s}}``. Inside the
    loop span its own name stands for time no child span covers; elsewhere
    ``(no span)`` is time with no span open on that thread."""
    from repro_torch.core import spans
    off = spans.clock_offset_ns()
    w0, w1 = int(t0_s * 1e9) + off, int(t1_s * 1e9) + off
    starts, ends = busy
    loop = _loop_thread(sp["spans"], kind)
    mine = [s for s in sp["spans"] if s.thread == loop and s.name not in RECORDED]
    inner, outer = collections.Counter(), collections.Counter()
    covered = 0
    for a, b, name, root in _innermost_segments(mine):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        idle = (b - a) - busy_within(starts, ends, [(a, b)])
        covered += idle
        (inner if root == LOOP[kind] else outer)[name] += idle
    total = (w1 - w0) - busy_within(starts, ends, [(w0, w1)])
    outer["(no span)"] += total - covered
    return {f"in {LOOP[kind]}": {k: v / 1e9 for k, v in inner.most_common()},
            "elsewhere": {k: v / 1e9 for k, v in outer.most_common()}}


def _innermost_segments(recs):
    """``(a, b, innermost, outermost)`` over one thread's nested spans: the
    stretches between consecutive span boundaries, each with the innermost
    and the outermost span open in it."""
    out, stack, cur = [], [], 0
    for s in sorted(recs, key=lambda s: (s.t0, -s.t1)):
        while stack and stack[-1][0] <= s.t0:
            t1, name, root = stack.pop()
            out.append((cur, t1, name, root))
            cur = t1
        if stack:
            out.append((cur, s.t0, stack[-1][1], stack[-1][2]))
        stack.append((s.t1, s.name, stack[0][2] if stack else s.name))
        cur = s.t0
    while stack:
        t1, name, root = stack.pop()
        out.append((cur, t1, name, root))
        cur = t1
    return [seg for seg in out if seg[1] > seg[0]]
