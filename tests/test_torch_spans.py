"""The port's span recorder (``repro_torch.core.spans``) on the CPU: off it
costs nothing and keeps nothing; on, spans nest by thread, self time is the
total less the children, cross-thread records keep their request, a full
buffer counts its drops, spans fall on the profiler's clock and appear
among its host events, and a direct map and a service burst record the
spans each layer boundary owes."""
import collections
import threading
import time
import tracemalloc

import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.core import spans
from repro_torch.core.api import SharedMapConfig, shared_map
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.serve.mapper import MappingService


@pytest.fixture
def recorder():
    spans.enable()
    yield spans
    spans.disable()
    spans.drain()


def test_off_returns_the_shared_noop_and_allocates_nothing():
    spans.disable()
    spans.drain()
    held = [None] * 2000   # every span kept: one object each would add up
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        for i in range(len(held)):
            held[i] = spans.span("service.round", req=i)
            with held[i] as sp:
                sp.set(req=i)
            spans.record("service.queue", 0, 1, req=i)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert all(h is spans.NOOP for h in held)
    assert peak - base < 1024
    assert spans.drain() == [] and spans.summary() == {}


def test_nesting_gives_parents_and_self_time(recorder):
    with spans.span("outer", req=7) as outer:
        time.sleep(0.002)
        with spans.span("inner"):
            time.sleep(0.003)
        with spans.span("inner"):
            with spans.span("leaf"):
                time.sleep(0.001)
        outer.set(members=2)
    got = {(s.name, s.t0): s for s in spans.drain()}
    by = collections.defaultdict(list)
    for s in got.values():
        by[s.name].append(s)
    (o,), inner, (leaf,) = by["outer"], by["inner"], by["leaf"]
    assert o.parent == 0 and o.req == 7 and o.attrs == {"members": 2}
    assert all(s.parent == o.id for s in inner) and leaf.parent == inner[1].id
    assert all(o.t0 <= s.t0 <= s.t1 <= o.t1 for s in inner + [leaf])
    summ = spans.summary(list(got.values()))
    kids = sum(s.t1 - s.t0 for s in inner)
    assert summ["outer"]["self_ns"] == (o.t1 - o.t0) - kids
    assert summ["inner"]["count"] == 2 and summ["inner"]["total_ns"] == kids
    assert summ["inner"]["self_ns"] == kids - (leaf.t1 - leaf.t0)
    assert summ["leaf"]["self_ns"] == summ["leaf"]["total_ns"] >= 1_000_000


def test_record_across_threads_keeps_its_request(recorder):
    t0 = time.perf_counter_ns()
    seen = []

    def other():
        with spans.span("worker", req=5):
            spans.record("service.queue", t0, time.perf_counter_ns(), req=42, lanes=3)
        seen.append(threading.get_ident())
    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    got = {s.name: s for s in spans.drain()}
    q = got["service.queue"]
    assert q.req == 42 and q.attrs == {"lanes": 3} and q.parent == 0
    assert q.t0 == t0 and q.thread == seen[0] != threading.get_ident()
    assert got["worker"].req == 5 and got["worker"].thread == seen[0]


def test_a_full_buffer_counts_its_drops(recorder, monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 5)
    for i in range(8):
        with spans.span("s", req=i):
            pass
    spans.record("r", 0, 1)
    assert spans.dropped() == 4
    assert [s.req for s in spans.drain()] == [0, 1, 2, 3, 4]
    spans.enable()
    assert spans.dropped() == 0


def test_spans_fall_on_the_profiler_clock(recorder):
    x = torch.arange(4096, dtype=torch.float32)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with spans.span("probe.span"):
            y = (x * 2.0 + 1.0).sum()
    assert float(y) > 0
    (s,) = spans.drain()
    off = spans.clock_offset_ns()
    lo, hi = s.t0 + off - 1_000_000, s.t1 + off + 1_000_000
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    ops = [e for e in events if e[0] in ("aten::mul", "aten::add", "aten::sum")]
    assert len(ops) >= 3 and all(lo <= a <= b <= hi for _, a, b in ops)
    (mine,) = [e for e in events if e[0] == "probe.span"]
    assert abs(mine[1] - (s.t0 + off)) < 1_000_000


def test_a_direct_map_records_its_layers(recorder):
    g = TG.gen_rgg(600, seed=3, device="cpu")
    h = Hierarchy(a=(4, 2, 2), d=(1.0, 10.0, 100.0))
    res = shared_map(g, h, SharedMapConfig(preset="fast"), device="cpu")
    got = spans.drain()
    names = collections.Counter(s.name for s in got)
    assert len(got) < 1000 and spans.dropped() == 0
    assert names["map"] == names["map.finalize"] == names["planner.result_fetch"] == 1
    assert names["planner.level"] == 3 and names["partitioner.batch"] >= 3
    for n in ("planner.plan", "planner.gather", "planner.advance", "planner.split",
              "planner.sync", "partitioner.coarsen", "partitioner.initial",
              "partitioner.refine", "partitioner.select"):
        assert names[n] >= 1, n
    # the planner's stats["levels"] read the same boundaries on the same clock
    levels = sorted((s for s in got if s.name == "planner.level"), key=lambda s: s.t0)
    assert [s.attrs["level"] for s in levels] == [0, 1, 2]
    assert [lv["seconds"] for lv in res.stats["levels"]] == \
        [(s.t1 - s.t0) / 1e9 for s in levels]
    (m,) = [s for s in got if s.name == "map"]
    assert all(m.t0 <= s.t0 <= s.t1 <= m.t1 for s in got)
    summ = spans.summary(got)
    assert 0 <= summ["map"]["self_ns"] < summ["map"]["total_ns"]


def test_a_service_burst_spans_every_job():
    h = Hierarchy(a=(4, 2), d=(1.0, 10.0))
    gs = [TG.gen_rgg(300, seed=40 + i, device="cpu") for i in range(4)]
    svc = MappingService(device="cpu")
    spans.enable()
    try:
        futs = svc.submit_many([(g, h, SharedMapConfig(preset="fast", seed=i))
                                for i, g in enumerate(gs)])
        assert all(f.result(timeout=120).pe_of.shape == (300,) for f in futs)
        svc.close()
    finally:
        spans.disable()
    got = spans.drain()
    per = collections.Counter((s.name, s.req) for s in got)
    seqs = sorted({s.req for s in got if s.name == "service.queue"})
    assert seqs == [1, 2, 3, 4]
    for q in seqs:
        assert per[("service.submit", q)] == per[("service.admit", q)] == 1
        assert per[("service.queue", q)] == per[("service.finalize", q)] == 1
        assert per[("planner.result_fetch", q)] == 1
        assert per[("planner.plan", q)] >= 1 and per[("planner.advance", q)] >= 1
    by_id = {s.id: s for s in got}
    rounds = [s for s in got if s.name == "service.round"]
    assert rounds and all(s.attrs["members"] >= 1 for s in rounds)
    kids = [s for s in got if s.parent in by_id and by_id[s.parent].name == "service.round"]
    assert {s.name for s in kids} >= {"planner.plan", "service.dispatch", "planner.advance",
                                      "planner.result_fetch"}
    for s in kids:
        r = by_id[s.parent]
        assert r.t0 <= s.t0 <= s.t1 <= r.t1 and s.thread == r.thread

