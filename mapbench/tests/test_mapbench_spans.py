"""The span readers (``mapbench/harness/spanrecords.py``): their arithmetic on
synthetic spans, their readings from a real CPU drive of each kind at a tiny
size with the recorder on, and an untraced run that keeps its line and
records nothing. The traced runner needs the card, so it is not run here."""
import collections
import statistics
import time

import numpy as np
import pytest

from mapbench.harness import manifest, runner, spanrecords
from mapbench.harness.drivers import Driver
from mapbench.tests.test_mapbench_faults import tiny_cell
from repro_torch.core import spans
from repro_torch.core.spans import Span

DIRECT = ("planner.host_ms.direct", "planner.sync_wait_ms.direct",
          "planner.root_level_device_s.direct", "partitioner.enqueue_ms.direct")
SERVICE = ("service.queue_wait_ms", "service.round_host_ms", "service.sync_wait_ms",
           "device.idle_in_rounds.service")
MS = 1_000_000


def sp(name, t0, t1, id, parent=0, thread=1, req=None, **attrs):
    return Span(name, t0 * MS, t1 * MS, id, parent, thread, req, attrs)


def part(kind, recs, units):
    return {"kind": kind, "spans": {"spans": recs, "summary": spans.summary(recs),
                                    "units": units, "dropped": 0}}


def read(name, rec):
    return manifest.reader(name)(rec)


def test_direct_readings_on_synthetic_spans():
    recs = []
    for k, base in enumerate((0, 100)):   # two maps of 100 ms
        i = 10 * k
        recs += [sp("map", base, base + 100, i + 1),
                 sp("planner.plan", base + 1, base + 11, i + 2, i + 1),
                 sp("planner.gather", base + 2, base + 6, i + 3, i + 2),
                 sp("partitioner.batch", base + 11, base + 81, i + 4, i + 1),
                 sp("planner.advance", base + 81, base + 91, i + 5, i + 1),
                 sp("planner.sync", base + 82, base + 88, i + 6, i + 5),
                 sp("planner.result_fetch", base + 91, base + 99, i + 7, i + 1),
                 sp("planner.sync", base + 92, base + 98, i + 8, i + 7),
                 sp("planner.level", base + 1, base + 91, i + 9, level=0,
                    device_ns=(50 + 20 * k) * MS)]
    rec = part("direct", recs, 2)
    # own time: plan 10 (gather's 4 inside), advance 10 - 6, result_fetch 8 - 6
    assert read("planner.host_ms.direct", rec) == pytest.approx(10 + 4 + 2)
    assert read("planner.sync_wait_ms.direct", rec) == pytest.approx(12)
    assert read("partitioner.enqueue_ms.direct", rec) == pytest.approx(70)
    assert read("planner.root_level_device_s.direct", rec) == pytest.approx(0.06)
    assert all(read(n, rec) is None for n in SERVICE)
    assert all(read(n, {"kind": "direct"}) is None for n in DIRECT)   # untraced


def test_service_readings_on_synthetic_spans():
    loop, pool = 1, 2
    recs = [sp("service.queue", 0, 30, 1, req=1), sp("service.queue", 0, 50, 2, req=2),
            sp("service.admit", 50, 54, 3, thread=loop, req=1),
            sp("planner.sync", 51, 52, 4, 3, thread=loop, req=1),
            sp("service.round", 60, 160, 5, thread=loop, members=2, dispatches=1),
            sp("planner.advance", 100, 130, 6, 5, thread=loop, req=1),
            sp("planner.sync", 110, 120, 7, 6, thread=loop, req=1),
            sp("service.finalize", 150, 158, 8, thread=pool, req=1),
            sp("planner.sync", 151, 155, 9, 8, thread=pool)]
    rec = part("service", recs, 2)
    rec["spans"].update(rounds_s=0.1, rounds_busy_s=0.025)
    assert read("service.queue_wait_ms", rec) == pytest.approx(40)
    assert read("service.round_host_ms", rec) == pytest.approx((100 - 10) / 2)
    assert read("service.sync_wait_ms", rec) == pytest.approx((1 + 10) / 2)   # not the pool's
    assert read("device.idle_in_rounds.service", rec) == pytest.approx(75)
    del rec["spans"]["rounds_s"]
    assert read("device.idle_in_rounds.service", rec) is None   # no device trace
    assert all(read(n, rec) is None for n in DIRECT)
    assert all(read(n, {"kind": "service"}) is None for n in SERVICE)


def test_union_busy_and_the_traced_part(monkeypatch):
    assert spanrecords.union([(5, 9), (0, 3), (2, 4), (8, 20)], 1, 15) == [(1, 4), (5, 15)]
    starts, ends = np.array([0, 10, 30]), np.array([5, 20, 40])
    assert spanrecords.busy_within(starts, ends, [(3, 12), (18, 35)]) == 2 + 2 + 2 + 5
    assert spanrecords.busy_within(starts, ends, []) == 0
    monkeypatch.setattr(spans, "_OFFSET_NS", 1000 * MS)
    recs = [sp("service.round", 0, 10, 1), sp("service.round", 12, 30, 2),
            sp("service.round", 40, 50, 3), sp("service.queue", 50, 60, 4, req=1)]
    ms = np.array([1000, 1025], np.int64) * MS
    me = np.array([1008, 1045], np.int64) * MS
    got = spanrecords.traced_part(recs, 3, 0.002, 0.048, busy=(ms, me))
    assert [s.t0 for s in got["spans"]] == [1000 * MS, 1012 * MS, 1040 * MS]
    assert got["units"] == 3 and got["summary"]["service.round"]["count"] == 3
    # the traced part [2, 48) ms: rounds [2, 10), [12, 30), [40, 48), 34 ms,
    # the card busy 6 + 5 + 5 ms of them and 26 ms of the part
    assert got["rounds_s"] == pytest.approx(0.034)
    assert got["rounds_busy_s"] == pytest.approx(0.016)
    by = spanrecords.idle_by_span(got, "service", 0.002, 0.048, (ms, me))
    assert by["in service.round"] == pytest.approx({"service.round": 0.018})
    assert by["elsewhere"] == pytest.approx({"(no span)": 0.002})


def test_idle_by_span_names_the_innermost(monkeypatch):
    monkeypatch.setattr(spans, "_OFFSET_NS", 0)
    recs = [sp("map", 0, 100, 1), sp("partitioner.batch", 10, 60, 2, 1),
            sp("partitioner.refine", 20, 50, 3, 2), sp("planner.level", 0, 90, 4),
            sp("other.thread", 0, 100, 5, thread=9)]
    busy = (np.array([0, 30], np.int64) * MS, np.array([5, 40], np.int64) * MS)
    got = spanrecords.idle_by_span({"spans": recs}, "direct", 0.0, 0.12, busy)
    assert got["in map"] == pytest.approx({"map": 0.045, "partitioner.batch": 0.02,
                                           "partitioner.refine": 0.02})
    assert got["elsewhere"] == pytest.approx({"(no span)": 0.02})


def drive(kind, seconds, at):
    """A tiny CPU window of ``kind`` with the recorder on, traced part
    ``at`` seconds long: (rec, the traced jobs, the spans)."""
    drv = Driver(tiny_cell(kind), 2**31 + 5, 5.0, "cpu")
    drv.make_inputs()
    drv.start()
    drv.warm()
    cut = {}

    def mark(units):
        cut.update(units=units, t1=time.perf_counter())
    spans.enable()
    try:
        t0 = time.perf_counter()
        win = drv.window(seconds, mark=(at, mark))
    finally:
        spans.disable()
        drv.close()
    got = spans.drain()
    rec = {"kind": kind,
           "spans": spanrecords.traced_part(got, cut["units"], t0, cut["t1"])}
    return rec, win["jobs"][:cut["units"]], rec["spans"]["spans"]


def test_a_direct_drive_reads_the_card_free_readings():
    rec, jobs, recs = drive("direct", 0.3, 0.1)
    units = len(jobs)
    assert units >= 1 and all(j.ok for j in jobs)
    names = collections.Counter(s.name for s in recs)
    assert names["map"] == units and len(recs) < 1000 * units
    got = {n: read(n, rec) for n in DIRECT}
    assert got["planner.root_level_device_s.direct"] is None   # device_ns: the card's
    assert all(got[n] > 0 for n in DIRECT if n != "planner.root_level_device_s.direct")
    map_ms = sum(s.t1 - s.t0 for s in recs if s.name == "map") / 1e6 / units
    host_ms = statistics.fmean(j.t1 - j.t0 for j in jobs) * 1e3
    assert map_ms <= host_ms
    assert (got["planner.host_ms.direct"] + got["planner.sync_wait_ms.direct"]
            + got["partitioner.enqueue_ms.direct"]) <= map_ms


def test_a_service_drive_reads_the_card_free_readings():
    rec, jobs, recs = drive("service", 0.4, 0.3)
    assert len(jobs) == 4 and all(j.ok for j in jobs)
    per = collections.Counter((s.name, s.req) for s in recs)
    reqs = {s.req for s in recs if s.name == "service.queue"}
    assert len(reqs) == 4
    assert all(per[("service.queue", r)] == per[("service.finalize", r)] == 1 for r in reqs)
    got = {n: read(n, rec) for n in SERVICE}
    assert got["device.idle_in_rounds.service"] is None   # the card's trace
    assert got["service.queue_wait_ms"] >= 0
    assert got["service.round_host_ms"] > 0 and got["service.sync_wait_ms"] > 0
    rounds_ms = sum(s.t1 - s.t0 for s in recs if s.name == "service.round") / 1e6
    assert got["service.round_host_ms"] * 4 <= rounds_ms


def test_an_untraced_benchmark_run_keeps_its_line_and_records_nothing(monkeypatch):
    # this process also holds the JAX package's tests: the run's own check
    # for loaded JAX modules guards the benchmark's process, not this one
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])
    spans.disable()
    spans.drain()
    line, rc = runner.run_cell(tiny_cell("direct"), 2**31 + 7, 0.3, False, "cpu",
                               time.perf_counter(), log=lambda s: None)
    assert rc == 0 and line["correct"], line
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"setup_s", "map_s", "cost_J"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert not spans.enabled() and spans.drain() == []
