"""A run's record, and the arithmetic the metric readers
(``mapbench/metrics/<name>.py``) apply to it. Each function returns None
where the record holds nothing for it (another kind of cell, or an untraced
run).

The record: ``kind`` (the traffic's kind), ``setup_s``, ``window_s``
(host clock), ``completed`` (maps, or jobs answered inside the window),
``latencies`` (every job of the window in the order begun, from its due
time to its result),
``levels`` (per map: host seconds of each hierarchy level),
``cost_J``, and in a traced run ``trace`` (:class:`trace.DeviceWindow`:
``busy_s``, ``device_ops``, ``kernels``, ``traced_s`` and ``units``, the maps
or jobs answered under it),
``roofline`` (:func:`trace.roofline_pass`), and ``counters``: the
program's counters over the window (over its traced part in a traced run),
where the kind reads any.
"""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile over all ``values``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return float(xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)])


def setup_s(rec):
    return rec.get("setup_s")


def cost_J(rec):
    return rec.get("cost_J")


def map_s(rec):
    """The whole window over the maps completed in it."""
    if rec["kind"] != "direct" or not rec.get("completed"):
        return None
    return rec["window_s"] / rec["completed"]


def job_p95_traced_s(rec):
    """The 95th percentile over the jobs of a traced run's traced part (those
    begun before its mark, every one answered under the trace), each from its
    due time to its result; a failed job counts as infinitely late."""
    tr = rec.get("trace")
    if rec["kind"] != "service" or not tr or not tr["units"]:
        return None
    p = percentile(rec["latencies"][:tr["units"]], 95)
    return p if math.isfinite(p) else None


def _levels(rec, pick):
    if rec["kind"] != "direct" or not rec.get("levels"):
        return None
    return float(np.mean([pick(lv) for lv in rec["levels"]]))


def root_level_s(rec):
    return _levels(rec, lambda lv: lv[0])


def lower_levels_s(rec):
    return _levels(rec, lambda lv: sum(lv[1:]))


def _per_unit(rec, kind, value):
    tr = rec.get("trace")
    if rec["kind"] != kind or not tr or not tr["units"]:
        return None
    return value(tr) / tr["units"]


def scan_ms(rec):
    return _per_unit(rec, "direct", lambda tr: tr["kernels"]["scan"]["ms"])


def coarsen_ms(rec):
    return _per_unit(rec, "direct", lambda tr: tr["kernels"]["hem_propose"]["ms"]
                     + tr["kernels"]["contract_edges"]["ms"])


def device_ops(rec, kind):
    return _per_unit(rec, kind, lambda tr: tr["device_ops"])


def roofline_pct(rec, kind):
    """The mapping kernels' summed least time over their summed device time."""
    rl = rec.get("roofline")
    if rec["kind"] != kind or not rl:
        return None
    dev = sum(k["device_ms"] for k in rl.values())
    return 100.0 * sum(k["bound_ms"] for k in rl.values()) / dev if dev > 0 else None


def idle_pct(rec, kind):
    tr = rec.get("trace")
    if rec["kind"] != kind or not tr or tr["traced_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["traced_s"])


def _coalesce(rec):
    return rec.get("counters", {}).get("coalesce") if rec["kind"] == "service" else None


def lanes_per_dispatch(rec):
    c = _coalesce(rec)
    return c["members"] / c["dispatches"] if c and c["dispatches"] else None


def padded_lane_share(rec):
    c = _coalesce(rec)
    if not c or not c["members"]:
        return None
    return 100.0 * c["padded_lanes"] / (c["members"] + c["padded_lanes"])
