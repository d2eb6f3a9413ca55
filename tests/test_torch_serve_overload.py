"""Overload, deadlines, fault containment and degradation in the port's
mapping service on the CPU: the service-level cases of the JAX package's
``tests/test_serve_overload.py``, each served result held bit for bit
against the port's direct path (which ``test_torch_serve_mapper.py`` holds
against the reference). The admission, retry and tracker unit cases are in
``test_torch_serve_leaves.py``; the card's error types are classified here."""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.core.api import SharedMapConfig, shared_map_direct
from repro_torch.core.baselines import greedy_baseline
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.mapping import evaluate_J
from repro_torch.faults import FaultInjector, InjectedFault
from repro_torch.serve.admission import (DeadlineExceededError, RetryPolicy,
                                         ServiceClosedError, ServiceOverloadError)
from repro_torch.serve.mapper import MappingService, validate_request
from repro_torch.serve.tracker import CounterTracker, InMemoryTracker, JsonlTracker, Tracker

ROOT = Path(__file__).resolve().parent.parent
H = Hierarchy(a=(4, 2), d=(1.0, 10.0))
CFG = SharedMapConfig(preset="fast")


@pytest.fixture(scope="module")
def graphs():
    return [TG.gen_rgg(300, seed=40 + i, device="cpu") for i in range(4)]


def _direct(g, cfg=CFG):
    return shared_map_direct(g, H, cfg, device="cpu")


def _svc(**kw):
    return MappingService(device="cpu", **kw)


def _same(res, ref):
    assert np.array_equal(res.pe_of, ref.pe_of) and res.J == ref.J


# ------------------------------------------------------------ the card's errors

def test_cuda_out_of_memory_is_transient():
    """``torch.cuda.OutOfMemoryError`` retries whatever its message; a failed
    kernel launch or an illegal address (a dead CUDA context) does not."""
    rp = RetryPolicy()
    assert rp.is_transient(torch.cuda.OutOfMemoryError("allocator gave up"))
    assert rp.is_transient(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not rp.is_transient(RuntimeError(
        "CUDA kernel lp_gain_f32 failed to launch: cudaError 700"))
    assert not rp.is_transient(RuntimeError(
        "CUDA error: an illegal memory access was encountered\nCUDA kernel errors "
        "might be asynchronously reported at some other API call"))


# ----------------------------------------------------------------- overload

def test_burst_shed_and_admitted_bit_identical(graphs):
    """Closed-loop burst over the bounds: overflow gets a typed
    ServiceOverloadError, admitted requests complete bit-identical to the
    direct path."""
    tr = InMemoryTracker()
    svc = _svc(max_inflight=1, max_queue=2, tracker=tr)
    try:
        futs = svc.submit_many(
            [(graphs[i % 4], H, SharedMapConfig(preset="fast", seed=i)) for i in range(6)])
        shed = [f for f in futs if isinstance(f.exception(timeout=600), ServiceOverloadError)]
        done = [f for f in futs if f.exception(timeout=600) is None]
        assert len(shed) == 4 and len(done) == 2
        assert shed[0] is futs[2]  # FIFO admission: first two got in
        exc = futs[2].exception()
        assert exc.queued == 2 and exc.retry_after_s > 0
        for i in (0, 1):
            r = futs[i].result()
            _same(r, _direct(graphs[i], SharedMapConfig(preset="fast", seed=i)))
            assert r.stats["degradation"]["level"] == 0
        snap = svc.stats()["admission"]
        assert snap["admitted"] == 2 and snap["shed"] == 4
        assert tr.counters["service.shed"] == 4
        assert tr.counters["service.admitted"] == 2
    finally:
        svc.close()


def test_priority_preempts_lowest_waiter(graphs):
    svc = _svc(max_queue=1)
    try:
        with svc._cv:  # freeze the scheduler: decisions are deterministic
            f_low = svc.submit(graphs[0], H, CFG, priority=0)
            f_high = svc.submit(graphs[1], H, CFG, priority=5)
        exc = f_low.exception(timeout=600)
        assert isinstance(exc, ServiceOverloadError) and "preempted" in str(exc)
        _same(f_high.result(timeout=600), _direct(graphs[1]))
        assert svc.stats()["admission"]["preempted"] == 1
    finally:
        svc.close()


def test_priority_orders_execution(graphs):
    order = []
    svc = _svc(max_inflight=1, batch_window_s=0.0)
    try:
        with svc._cv:
            for gi, pri in ((0, 0), (1, 5), (2, 1)):
                fut = svc.submit(graphs[gi], H, CFG, priority=pri)
                fut.add_done_callback(lambda f, gi=gi: order.append(gi))
            assert len(svc._queue) == 3
        svc.close(wait=True)  # drain: all three resolve before return
        assert order == [1, 2, 0]  # high priority first, FIFO below
    finally:
        svc.close()


# ----------------------------------------------------------------- deadlines

def test_deadline_expired_at_submit(graphs):
    svc = _svc()
    try:
        fut = svc.submit(graphs[0], H, SharedMapConfig(preset="fast", seed=99), deadline_s=0.0)
        assert isinstance(fut.exception(timeout=5), DeadlineExceededError)
        assert svc.stats()["admission"]["deadline_miss"] == 1
    finally:
        svc.close()


def test_deadline_expires_in_queue(graphs):
    svc = _svc()
    try:
        with svc._cv:  # hold the scheduler so the request stays queued
            fut = svc.submit(graphs[0], H, SharedMapConfig(preset="fast", seed=98),
                             deadline_s=0.01)
            time.sleep(0.05)  # deadline passes while queued
        assert isinstance(fut.exception(timeout=10), DeadlineExceededError)
        _same(svc.map(graphs[0], H, CFG), _direct(graphs[0]))   # still serving
    finally:
        svc.close()


def test_deadline_cancels_mid_pipeline():
    """A deadline shorter than one level of a larger graph is enforced at
    the cooperative between-level checkpoints (the port compiles nothing,
    so the request is made long by its size, not by a cold compile)."""
    g = TG.gen_rgg(3000, seed=5, device="cpu")
    svc = _svc()
    try:
        fut = svc.submit(g, H, CFG, deadline_s=0.05)
        assert isinstance(fut.exception(timeout=600), DeadlineExceededError)
        _same(svc.map(g, H, CFG), _direct(g))   # the scheduler thread survived
    finally:
        svc.close()


def test_checkpoint_aborts_between_levels(graphs):
    calls = []
    shared_map_direct(graphs[0], H, CFG, checkpoint=lambda: calls.append(1), device="cpu")
    assert len(calls) >= 2  # once per level at least

    class Abort(Exception):
        pass

    seen = []

    def ck():
        seen.append(1)
        if len(seen) == 2:
            raise Abort()

    with pytest.raises(Abort):
        shared_map_direct(graphs[0], H, CFG, checkpoint=ck, device="cpu")
    assert len(seen) == 2  # aborted at the second level boundary


# ------------------------------------------------------- faults / containment

def test_transient_dispatch_fault_retried_bit_identical(graphs):
    inj = FaultInjector(fail_at={"dispatch": (0, 1)})
    svc = _svc(fault_injector=inj, retry=RetryPolicy(backoff_base_s=0.001))
    try:
        r = svc.map(graphs[0], H, CFG)
        _same(r, _direct(graphs[0]))
        assert r.stats["degradation"]["level"] == 0
        flt = svc.stats()["faults"]
        assert flt["dispatch_failures"] >= 1 and flt["isolated"] >= 1
        assert flt["retries"] >= 1
        assert inj.fired == [("dispatch", 0), ("dispatch", 1)]
    finally:
        svc.close()


def test_persistent_transient_failure_degrades_to_greedy(graphs):
    inj = FaultInjector(rates={"dispatch": 1.0})
    svc = _svc(fault_injector=inj, retry=RetryPolicy(max_retries=1, backoff_base_s=0.001))
    try:
        r = svc.map(graphs[0], H, CFG)
        deg = r.stats["degradation"]
        assert deg["level"] == 3 and deg["mode"] == "greedy"
        expect = greedy_baseline(graphs[0], H, seed=CFG.seed, device="cpu")
        assert np.array_equal(r.pe_of, expect)
        assert r.J == evaluate_J(graphs[0], H, expect, device="cpu")
        assert r.stats["backend"] == "xla"
        flt = svc.stats()["faults"]
        assert flt["contained"] >= 1 and flt["degraded"] >= 1
    finally:
        svc.close()


def test_failure_degrades_to_fast_preset_rung(graphs):
    """An eco request whose pipeline fails falls to the fast-preset rung (a
    real multisection result, the direct fast run's) and the degraded answer
    is never cached under the original request."""
    inj = FaultInjector(fail_at={"dispatch": (0, 1)})
    cfg_eco = SharedMapConfig(preset="eco")
    svc = _svc(fault_injector=inj, retry=RetryPolicy(max_retries=0, backoff_base_s=0.001))
    try:
        r = svc.map(graphs[1], H, cfg_eco)
        deg = r.stats["degradation"]
        assert deg["level"] == 2 and deg["mode"] == "fast_preset"
        _same(r, _direct(graphs[1]))
        again = svc.map(graphs[1], H, cfg_eco)
        assert again.stats["result_cache"]["hit"] is False
        assert again.stats["degradation"]["level"] == 0
        _same(again, _direct(graphs[1], cfg_eco))
    finally:
        svc.close()


@pytest.mark.parametrize("degrade", [True, False])
def test_nontransient_or_undegraded_failure_propagates(graphs, degrade):
    inj = FaultInjector(rates={"dispatch": 1.0}, transient=not degrade)
    svc = _svc(fault_injector=inj, degrade_on_failure=degrade,
               retry=RetryPolicy(max_retries=0))
    try:
        with pytest.raises(InjectedFault):
            svc.map(graphs[0], H, SharedMapConfig(preset="fast", seed=11 + degrade))
        assert svc._thread.is_alive()  # containment: scheduler survived
    finally:
        svc.close()


def test_finalize_fault_degrades(graphs):
    svc = _svc(fault_injector=FaultInjector(fail_at={"finalize": (0,)}))
    try:
        assert svc.map(graphs[3], H, CFG).stats["degradation"]["level"] > 0
    finally:
        svc.close()


def test_cache_fault_contained(graphs):
    svc = _svc(fault_injector=FaultInjector(fail_at={"cache": (0, 1)}))
    try:
        r = svc.map(graphs[0], H, CFG)
        _same(r, _direct(graphs[0]))
        assert r.stats["degradation"]["level"] == 0
        assert svc.stats()["faults"]["cache_faults"] == 2
        # the put was skipped -> same request recomputes (then caches)
        assert svc.map(graphs[0], H, CFG).stats["result_cache"]["hit"] is False
        assert svc.map(graphs[0], H, CFG).stats["result_cache"]["hit"] is True
    finally:
        svc.close()


def test_degrade_on_overload_inline_ladder(graphs):
    svc = _svc(degrade_on_overload=True)
    try:
        primed = svc.map(graphs[0], H, CFG)  # populate the nearby index
        svc.admission.max_queue = 0  # force hard overload
        near = svc.map(graphs[0], H, SharedMapConfig(preset="eco", seed=7))
        assert near.stats["degradation"]["mode"] == "cached_nearby"
        assert near.stats["degradation"]["level"] == 1
        assert np.array_equal(near.pe_of, primed.pe_of)
        cold = svc.map(graphs[1], H, CFG)
        assert cold.stats["degradation"]["mode"] == "greedy"
        assert np.array_equal(cold.pe_of, greedy_baseline(graphs[1], H, seed=CFG.seed,
                                                          device="cpu"))
        assert svc.stats()["admission"]["degraded"] == 2
    finally:
        svc.close()


# ------------------------------------------------------ validation boundary

def test_validation_rejects_malformed_inputs(graphs):
    g = graphs[0]
    svc = _svc()
    try:
        with pytest.raises(ValueError, match="empty graph"):
            svc.submit(g._replace(n=torch.tensor(0, dtype=g.n.dtype)), H, CFG)
        with pytest.raises(ValueError, match="k=8"):
            svc.submit(TG.gen_rgg(6, seed=1, device="cpu"), H, CFG)  # k > n
        with pytest.raises(ValueError, match="eps"):
            svc.submit(g, H, SharedMapConfig(eps=0.0))
        with pytest.raises(ValueError, match="strategy"):
            svc.submit(g, H, SharedMapConfig(strategy="quantum"))
        with pytest.raises(ValueError, match="preset"):
            svc.submit(g, H, SharedMapConfig(preset="turbo"))
        bad_cols = g.cols.clone()
        bad_cols[0] = 10 ** 6
        with pytest.raises(ValueError, match="out of range"):
            svc.submit(g._replace(cols=bad_cols), H, CFG)
    finally:
        svc.close()


def test_validate_request_direct():
    with pytest.raises(ValueError):
        validate_request(TG.gen_rgg(6, seed=1, device="cpu"), H, CFG)
    validate_request(TG.gen_rgg(64, seed=1, device="cpu"), H, CFG)  # clean passes


def test_submit_many_mixed_batch_isolated(graphs):
    svc = _svc()
    try:
        small = TG.gen_rgg(6, seed=1, device="cpu")  # k > n: fails validation
        futs = svc.submit_many([(graphs[0], H, CFG), (small, H, CFG), (graphs[1], H, CFG)])
        assert isinstance(futs[1].exception(timeout=600), ValueError)
        for i, gi in ((0, 0), (2, 1)):
            _same(futs[i].result(timeout=600), _direct(graphs[gi]))
    finally:
        svc.close()


def test_corrupt_graph_isolated_without_validation(graphs):
    """With validation off, a corrupt graph (a truncated adjacency) fails
    deep in the pipeline — but only ITS request."""
    corrupt = graphs[0]._replace(cols=graphs[0].cols[:3].clone())
    svc = _svc(validate=False)
    try:
        futs = svc.submit_many([(graphs[2], H, CFG), (corrupt, H, CFG), (graphs[3], H, CFG)])
        exc = futs[1].exception(timeout=600)
        assert exc is not None and not isinstance(exc, ServiceOverloadError)
        for i, gi in ((0, 2), (2, 3)):
            _same(futs[i].result(timeout=600), _direct(graphs[gi]))
        assert svc._thread.is_alive()
    finally:
        svc.close()


# ------------------------------------------------------------------ shutdown

def test_close_nowait_fails_pending_futures():
    """close(wait=False) FAILS (never leaks) every pending Future, with a
    long request in flight."""
    svc = _svc()
    fut = svc.submit(TG.gen_rgg(4000, seed=6, device="cpu"), H, CFG)
    time.sleep(0.05)  # let the scheduler pick it up
    t0 = time.time()
    svc.close(wait=False)
    assert time.time() - t0 < 5.0  # prompt, not drain
    assert isinstance(fut.exception(timeout=0.1), ServiceClosedError)
    with pytest.raises(ServiceClosedError):
        svc.submit(TG.gen_rgg(50, seed=1, device="cpu"), H, CFG)


def test_context_manager_exits_deterministically(graphs):
    with _svc() as svc:
        fut = svc.submit(graphs[0], H, CFG)
    assert fut.result(timeout=1) is not None

    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with _svc() as svc2:
            with svc2._cv:  # keep it queued so it is provably pending
                fut2 = svc2.submit(graphs[1], H, SharedMapConfig(preset="fast", seed=77))
                raise Boom()
    assert isinstance(fut2.exception(timeout=5), ServiceClosedError)


# ---------------------------------------------------------------- trackers

def test_jsonl_tracker_records_service_history(tmp_path, graphs):
    path = str(tmp_path / "svc.jsonl")
    tr = JsonlTracker(path)
    svc = _svc(tracker=tr)
    try:
        for _ in range(2):
            svc.map(graphs[0], H, SharedMapConfig(preset="fast", seed=21))
    finally:
        svc.close()
        tr.close()
    recs = [json.loads(line) for line in open(path)]
    names = [r["name"] for r in recs]
    assert "service.admitted" in names
    assert "service.cache.hit" in names and "service.cache.miss" in names
    assert all("t" in r and r["kind"] in ("count", "event") for r in recs)


def test_counter_tracker_aggregates_service_counters(graphs):
    tr = CounterTracker()
    svc = _svc(tracker=tr)
    try:
        for _ in range(2):
            svc.map(graphs[0], H, SharedMapConfig(preset="fast", seed=22))
        snap = svc.stats()
    finally:
        svc.close()
    counters = snap["tracker"]["counters"]
    assert counters["service.admitted"] == 1
    assert counters["service.cache.miss"] == 1 and counters["service.cache.hit"] == 1
    gauges = snap["tracker"]["gauges"]
    assert gauges["service.queue_depth"] == 0 and gauges["service.cache_entries"] == 1


def test_raising_tracker_never_breaks_serving(graphs):
    class BadSink(Tracker):
        def count(self, name, value=1, **tags):
            raise RuntimeError("sink down")

        def event(self, name, **fields):
            raise RuntimeError("sink down")

    svc = _svc(tracker=BadSink(), max_inflight=1, max_queue=1)
    try:
        _same(svc.map(graphs[0], H, CFG), _direct(graphs[0]))
    finally:
        svc.close()


def test_every_future_resolves_under_fault_and_overload(graphs):
    inj = FaultInjector(seed=3, rates={"dispatch": 0.3})
    svc = _svc(max_inflight=2, max_queue=4, fault_injector=inj,
               retry=RetryPolicy(max_retries=1, backoff_base_s=0.001))
    try:
        futs = []
        for wave in range(4):
            futs += svc.submit_many(
                [(graphs[i % 4], H, SharedMapConfig(preset="fast", seed=100 + wave * 5 + i))
                 for i in range(5)])
        outcomes = {"ok": 0, "shed": 0}
        for f in futs:
            exc = f.exception(timeout=600)
            if exc is None:
                assert f.result().stats["degradation"]["level"] in (0, 1, 2, 3)
                outcomes["ok"] += 1
            else:
                assert isinstance(exc, ServiceOverloadError), exc
                outcomes["shed"] += 1
        assert outcomes["ok"] + outcomes["shed"] == 20 and outcomes["ok"] > 0
        assert svc._thread is None or svc._thread.is_alive()
    finally:
        svc.close()


def test_retry_backoff_never_overruns_deadline(graphs):
    """Each backoff sleep is capped at the remaining budget and the deadline
    is re-checked before any re-dispatch: under a tight deadline the outcome
    is DeadlineExceededError, never a late success."""
    inj = FaultInjector(fail_at={"dispatch": tuple(range(50))})
    svc = _svc(fault_injector=inj, degrade_on_failure=False,
               retry=RetryPolicy(max_retries=5, backoff_base_s=0.5))
    try:
        t0 = time.monotonic()
        exc = svc.submit(graphs[0], H, CFG, deadline_s=0.2).exception(timeout=120)
        elapsed = time.monotonic() - t0
        assert isinstance(exc, DeadlineExceededError), exc
        assert elapsed < 5.0, f"late failure after {elapsed:.2f}s"
    finally:
        svc.close()


def test_jsonl_tracker_flushed_after_mapper_teardown():
    """The tracker module's atexit flush is registered before the mapper's
    teardown hook (atexit runs LIFO), so a service left open at exit still
    lands its tracker's events on disk."""
    code = ("import sys; sys.path.insert(0, sys.argv[2])\n"
            "from repro_torch.serve.tracker import JsonlTracker\n"
            "from repro_torch.serve.mapper import MappingService\n"
            "tr = JsonlTracker(sys.argv[1])\n"
            "svc = MappingService(tracker=tr, device='cpu')\n"
            "tr.event('sentinel', n=1)\n")
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/exit.jsonl"
        subprocess.run([sys.executable, "-c", code, path, str(ROOT / "src")],
                       check=True, timeout=300)
        lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert any(e.get("name") == "sentinel" for e in lines)
