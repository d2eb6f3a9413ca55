"""The mapping service's leaf modules in the port (``serve.tracker``,
``serve.admission``) against the JAX package's on the CPU: the same
``CounterTracker`` text for the same emits, the same snapshots and JSONL
records, ``AdmissionController.decide`` and its bookkeeping over a grid of
states, and ``RetryPolicy``'s backoff and transience classification."""
import itertools
import json
import logging
import time

import pytest

from repro import faults as JF
from repro.serve import admission as JA
from repro.serve import tracker as JT
from repro_torch import faults as TF
from repro_torch.serve import admission as TA
from repro_torch.serve import tracker as TT


def _emit(tr):
    """One stream of emits: counters with and without tags, gauges, events
    with numeric, string and bool fields, names that need sanitising."""
    tr.count("reqs", 2, route="a")
    tr.count("reqs", 3, route="a")
    tr.count("reqs", route="b")
    tr.count("service.retry", 1, attempt=2, site="dispatch")
    tr.count("9lives")
    if hasattr(tr, "gauge"):
        tr.gauge("depth", 7)
        tr.gauge("depth", 4)
        tr.gauge("cache.entries", 12.5, tier="lru")
    tr.event("shed", queued=9, reason="full", ok=True)
    tr.event("shed", queued=3, inflight=2)
    tr.event("retry", backoff_s=0.04)


def test_counter_tracker_textfile_bytes_equal(tmp_path):
    port, ref = TT.CounterTracker(), JT.CounterTracker()
    assert port.to_textfile() == ref.to_textfile() == ""
    for tr in (port, ref):
        _emit(tr)
    assert port.snapshot() == ref.snapshot()
    assert port.to_textfile().encode() == ref.to_textfile().encode()
    assert 'reqs{route="a"} 5.0' in port.to_textfile()
    port.write_textfile(str(tmp_path / "port.prom"))
    ref.write_textfile(str(tmp_path / "ref.prom"))
    assert (tmp_path / "port.prom").read_bytes() == (tmp_path / "ref.prom").read_bytes()
    assert not list(tmp_path.glob("*.tmp.*"))


def test_in_memory_and_jsonl_trackers_match(tmp_path):
    port, ref = TT.InMemoryTracker(), JT.InMemoryTracker()
    for tr in (port, ref):
        _emit(tr)
    assert port.counters == ref.counters and port.events == ref.events
    paths = {}
    for name, mod in (("port", TT), ("ref", JT)):
        tr = mod.JsonlTracker(str(tmp_path / f"{name}.jsonl"))
        _emit(tr)
        tr.close()
        tr.close()   # closing twice is safe
        with pytest.raises(ValueError):
            tr.count("y")
        paths[name] = [{k: v for k, v in json.loads(line).items() if k != "t"}
                       for line in open(tmp_path / f"{name}.jsonl")]
    assert paths["port"] == paths["ref"] and len(paths["port"]) == 8


def test_composite_and_safe_emit_swallow_sink_errors(caplog):
    class Broken(TT.Tracker):
        def count(self, name, value=1, **tags):
            raise RuntimeError("sink down")

        def event(self, name, **fields):
            raise RuntimeError("sink down")
    mem = TT.InMemoryTracker()
    comp = TT.CompositeTracker(Broken(), mem)
    comp.count("a", 2)
    comp.event("b", x=1)
    comp.flush()
    comp.close()
    TT.safe_emit(Broken().count, "c")
    assert mem.counters == {"a": 2} and mem.events == [{"name": "b", "x": 1}]
    TT.NULL_TRACKER.count("x")
    TT.NULL_TRACKER.event("y")
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        TT.LogTracker().count("reqs", 3, route="a")
    assert "count reqs += 3" in caplog.text


STATES = list(itertools.product(
    [0, 1, 4],              # max_queue
    [0.0, 0.5, 0.75, 1.0],  # degrade_at
    [0, 1, 2, 3, 4, 5],     # queued
))


@pytest.mark.parametrize("max_queue,degrade_at,queued", STATES)
def test_admission_decide_matrix_equals_the_reference(max_queue, degrade_at, queued):
    port = TA.AdmissionController(max_inflight=2, max_queue=max_queue, degrade_at=degrade_at)
    ref = JA.AdmissionController(max_inflight=2, max_queue=max_queue, degrade_at=degrade_at)
    for c in (port, ref):
        c.queued = queued
    assert (port.hard_bound(), port.soft_bound(), port.overloaded()) == \
        (ref.hard_bound(), ref.soft_bound(), ref.overloaded())
    for prio, waiting, degrade_ok in itertools.product([0, 1, 2], [None, 0, 1, 2], [False, True]):
        assert port.decide(prio, waiting, degrade_ok) == ref.decide(prio, waiting, degrade_ok)
    assert {TA.ADMIT, TA.ADMIT_DEGRADED, TA.PREEMPT, TA.SHED} == \
        {JA.ADMIT, JA.ADMIT_DEGRADED, JA.PREEMPT, JA.SHED}


def test_admission_bookkeeping_equals_the_reference():
    ops = ["note_queued", "note_start", "note_degraded", "note_dequeued", "note_shed",
           "note_start", "note_deadline_miss", "note_done", "note_queued", "note_done"]
    port = TA.AdmissionController(max_inflight=1, max_queue=1)
    ref = JA.AdmissionController(max_inflight=1, max_queue=1)
    for op in ops:
        for c in (port, ref):
            getattr(c, op)()
        assert port.snapshot() == ref.snapshot()
        assert port.has_capacity() == ref.has_capacity()
    port.note_shed(preempted=True)
    ref.note_shed(preempted=True)
    assert port.snapshot() == ref.snapshot() and port.snapshot()["preempted"] == 1


@pytest.mark.parametrize("base,factor", [(0.02, 2.0), (0.01, 3.0), (10.0, 1.5)])
def test_retry_backoff_equals_the_reference(base, factor):
    port = TA.RetryPolicy(max_retries=3, backoff_base_s=base, backoff_factor=factor)
    ref = JA.RetryPolicy(max_retries=3, backoff_base_s=base, backoff_factor=factor)
    for attempt in range(6):
        assert port.backoff_s(attempt) == ref.backoff_s(attempt)
    assert port.backoff_s(0, deadline=time.monotonic() - 1) == 0.0
    assert port.backoff_s(4, deadline=time.monotonic() + 0.05) <= 0.05


def test_retry_transience_equals_the_reference():
    class Crash(RuntimeError):
        transient = True

    class Fatal(RuntimeError):
        transient = False
    cases = [Crash("worker died"), Fatal("bad graph"), MemoryError(), ValueError("malformed"),
             RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
             RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
             RuntimeError("UNAVAILABLE: socket closed"), RuntimeError("boom"),
             TF.InjectedFault("x", transient=True), TF.InjectedFault("x", transient=False),
             JF.InjectedFault("x", transient=True)]
    port, ref = TA.RetryPolicy(), JA.RetryPolicy()
    assert [port.is_transient(e) for e in cases] == [ref.is_transient(e) for e in cases]
    assert port.is_transient(cases[5])   # the card's out-of-memory error retries


def test_errors_carry_the_reference_fields():
    e = TA.ServiceOverloadError("full", queued=3, inflight=2, retry_after_s=0.5)
    assert (e.queued, e.inflight, e.retry_after_s, str(e)) == (3, 2, 0.5, "full")
    assert issubclass(TA.DeadlineExceededError, TimeoutError)
    assert issubclass(TA.ServiceClosedError, RuntimeError)
