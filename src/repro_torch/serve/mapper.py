"""Batched, cached, overload-safe mapping service (the port's own copy of
the JAX package's ``serve.mapper``; DESIGN.md §9–§10).

Turns the one-shot ``shared_map`` entry point into a long-lived service for
heavy mapping traffic on one device (``device=``: None = the card, which
must exist). Every request's graph is moved there first. Three throughput
mechanisms, all bit-transparent:

* **Cross-request coalescing** — every in-flight request runs on a
  ``core.multisection.LevelPlanner``; a single scheduler thread gathers the
  per-level :class:`PlanGroup`s of ALL active planners, merges groups with
  equal ``exec_key`` and dispatches each merged set as ONE stacked
  ``batched_partition`` call, which runs every lane of the dispatch in one
  batched v-cycle (each kernel launch covers all lanes). Lanes are
  independent, so each request's result is bit-identical to the direct
  path (tested).
* **Content-addressed result cache** — requests are fingerprinted by their
  real CSR arrays + hierarchy vector + config, byte for byte as the JAX
  package fingerprints them (``backend`` enters resolved for the service's
  device); repeats are answered from an LRU cache. Concurrent identical
  requests dedup onto one in-flight computation. The real slices of a
  graph's four fields are fetched to the host ONCE per request
  (:func:`host_view`) and serve the fingerprint, the validation and a
  worker's payload.
* **Warmup** — :meth:`MappingService.warmup` has no program cache to fill:
  it builds and loads the kernel library (``nvcc`` at first use) and runs
  each expected (shape, k, ELL cap, batch) group once, so that the caching
  allocator holds its blocks.

And a robustness layer that makes the service survive bursty, adversarial
load — mapping sits in the launch critical path:

* **Admission control + backpressure** — bounded waiting queue and bounded
  in-flight set (``serve/admission.py``). Overflow is LOAD-SHED with an
  explicit :class:`ServiceOverloadError` (never silent queueing); a
  higher-priority arrival preempts the lowest-priority waiter instead.
  ``submit(..., deadline_s=...)`` cancels work past its deadline both in
  the queue and mid-pipeline (cooperative checkpoints between
  multisection levels).
* **Fault containment + retries** — a failed dispatch fails only the
  requests riding in it: the merged batch is re-executed per request
  (isolation), transient errors (injected faults, out-of-memory) are
  retried with exponential backoff, and the scheduler thread never dies.
  Every accepted Future resolves — with a result or a typed error — on
  success, failure, deadline, ``close()``, or interpreter teardown.
* **Graceful degradation** — under overload (opt-in) or after repeated
  transient failures (default), requests fall down a quality ladder:
  cached-nearby result → ``fast`` preset → greedy baseline
  (``core/baselines.greedy_baseline``, on the service's device); the level
  taken is reported in ``stats["degradation"]``.
* **Observability + fault injection** — a pluggable :class:`Tracker`
  (``serve/tracker.py``) streams admission/shed/retry/deadline/cache
  counters to log, memory, or JSON-lines sinks, and a seeded
  ``repro_torch.faults.FaultInjector`` exercises the dispatch/cache/finalize
  seams deterministically. With ``core.spans`` recording (off by default),
  each request's submit, queue wait, admission and finalize are host spans
  carrying the request's ``seq``; rounds, dispatches and the batch window
  are spans too, shared by the requests they serve.

And a durability + supervision layer (DESIGN.md §12):

* **Durable result store** — ``store_path=`` plugs a crash-safe
  content-addressed :class:`~repro_torch.serve.store.ResultStore` in as
  the persistence tier behind the LRU: every full-quality result is
  atomically published to disk, and a restarted service warm-starts — an
  LRU miss falls through to the store and serves the bit-identical result
  the same request would recompute. Corrupt/truncated entries are
  checksum-detected, quarantined (``stats["store"]["corrupt"]``), and never
  returned. Keys and entries are the JAX package's, so a store written by
  either package's service is served by the other's.
* **Supervised workers** — ``workers=N`` executes requests in
  ``serve/supervisor.py`` worker PROCESSES (spawned, heartbeat-monitored,
  each with its own CUDA context on the card): a worker crash — a failed
  launch, an OOM kill, SIGKILL — is detected, the worker restarts with
  capped exponential backoff, and its in-flight request is re-dispatched
  so the Future still resolves. A repeatedly-crashing request fails with a
  typed transient ``WorkerCrashError`` and falls into the normal
  degradation ladder. (Process isolation supersedes cross-request
  coalescing: worker mode trades merged dispatches for crash containment.)
* **Shadow verification** — ``shadow_verify_fraction=p`` re-executes that
  fraction of ``strategy="device"`` results against the bitwise host-mirror
  twin (``resident=False``); a divergence is recorded to the tracker,
  the lying entry is evicted + quarantined, and the device pipeline is
  quarantined for the rest of the session (subsequent device requests run
  the host-mirror path). ``stats["shadow"]`` carries the sample counters.

Usage::

    svc = MappingService(tracker=JsonlTracker("mapper.jsonl"))   # the card
    with svc.installed():              # route shared_map through the service
        res = shared_map(g, h)         # coalesced + cached transparently
    fut = svc.submit(g, h, cfg, priority=1, deadline_s=0.5)
    res = await svc.amap(g, h)
    svc.close()

    svc = MappingService(store_path="/var/cache/mapper", workers=2)
    cpu = MappingService(device="cpu")   # the plain versions on the CPU

The non-plannable strategies (``naive``/``queue``) fall back to the direct
path on a small thread pool — still cached and admission-controlled,
never coalesced.

Threads: the scheduler thread and the fallback pool's threads launch on
the device's default stream, so a pool thread's ``evaluate_J`` reads the
labels the scheduler thread produced in stream order, with no extra sync.
"""
from __future__ import annotations

import asyncio
import atexit
import dataclasses
import hashlib
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np

from ..core import api as capi
from ..core import spans
from ..core.api import SharedMapConfig, SharedMapResult
from ..core.baselines import greedy_baseline
from ..core.graph import Graph, from_edges, resolve_device
from ..core.hierarchy import Hierarchy
from ..core.mapping import evaluate_J
from ..core.multisection import (LevelPlanner, PlanGroup, _ell_deg_for, _next_pow2,
                                 dispatch_group_batch, execute_group_batch,
                                 fetch_group_batch, host_graph_from)
from ..core.partition import num_levels
from ..core.refine import resolve_backend
from ..core.taskgraph import TaskGraph
from ..faults import NULL_INJECTOR, FaultInjector, _hash_uniform
from .admission import (ADMIT, ADMIT_DEGRADED, PREEMPT, SHED, AdmissionController,
                        DeadlineExceededError, RetryPolicy, ServiceClosedError,
                        ServiceOverloadError)
from .store import ResultStore
from .supervisor import SupervisedWorkerPool
from .tracker import NULL_TRACKER, Tracker, safe_emit

STRATEGIES = ("naive", "layer", "bucket", "queue", "device")
_PLANNABLE = ("bucket", "layer", "device")
_PRESETS = ("fast", "eco", "strong")

# degradation ladder levels (stats["degradation"]["level"])
DEGRADE_FULL = 0           # full-quality result (the normal path)
DEGRADE_CACHED_NEARBY = 1  # cached result for the same graph, other config
DEGRADE_FAST_PRESET = 2    # recomputed with the cheapest preset
DEGRADE_GREEDY = 3         # greedy baseline floor (no multisection)


@dataclasses.dataclass
class HostView:
    """The real slices of a graph's four fields on the host (``vwgt[:n]``,
    ``rows/cols/ewgt[:m]``), fetched once per request by :func:`host_view`."""

    n: int
    m: int
    vwgt: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    ewgt: np.ndarray


def host_view(g: Graph) -> HostView:
    """Fetch ``g``'s real slices to the host: one copy per field (about 112
    MB at rgg 2^20 with 9.04 M directed edges)."""
    n, m = int(g.n), int(g.m)
    vwgt, rows, cols, ewgt = (a[:k].cpu().numpy() for a, k in
                              ((g.vwgt, n), (g.rows, m), (g.cols, m), (g.ewgt, m)))
    return HostView(n=n, m=m, vwgt=vwgt, rows=rows, cols=cols, ewgt=ewgt)


def graph_fingerprint(g: Graph, h: Hierarchy, tg: TaskGraph | None = None,
                      view: HostView | None = None) -> bytes:
    """Content address of the (graph, hierarchy) pair alone — the REAL CSR
    arrays (padding never affects planning) plus the hierarchy vectors.
    Keys the degradation ladder's cached-nearby index: any cached result
    for the same graph+hierarchy is 'nearby' whatever its config.

    When the request arrived as a workload-layer :class:`TaskGraph`, its
    canonical-form ``fingerprint()`` substitutes for hashing the doubled
    CSR — cheaper, and stable across whatever edge order the producer
    emitted. The bytes are the JAX package's for the same request.
    ``view`` is ``g``'s :func:`host_view` if the caller has one."""
    hs = hashlib.blake2b(digest_size=16)
    if tg is not None:
        hs.update(b"TG")
        hs.update(tg.fingerprint())
        hs.update(repr((tuple(h.a), tuple(h.d))).encode())
        return hs.digest()
    v = view if view is not None else host_view(g)
    for arr in (v.vwgt, v.rows, v.cols, v.ewgt):
        a = np.ascontiguousarray(arr)
        hs.update(str(a.dtype).encode())
        hs.update(a.tobytes())
    hs.update(repr((v.n, v.m, tuple(h.a), tuple(h.d))).encode())
    return hs.digest()


def _config_fingerprint(gfp: bytes, cfg: SharedMapConfig, backend: str) -> bytes:
    """The request fingerprint from the graph's and the resolved backend."""
    hs = hashlib.blake2b(digest_size=16)
    hs.update(gfp)
    hs.update(repr((float(cfg.eps), cfg.preset, cfg.strategy, int(cfg.seed),
                    bool(cfg.adaptive), backend,
                    bool(cfg.refine_mapping))).encode())
    return hs.digest()


def request_fingerprint(g: Graph, h: Hierarchy, cfg: SharedMapConfig,
                        tg: TaskGraph | None = None, device=None,
                        view: HostView | None = None) -> bytes:
    """Content address of a mapping request: the graph fingerprint plus
    every config field that influences the result. ``backend`` enters
    resolved for ``device`` (None = the card): ``auto`` is ``ell`` on the
    card and ``xla`` on the CPU, so on the CPU the bytes are the JAX
    package's and auto/xla hit the same entry."""
    backend = resolve_backend(cfg.backend, resolve_device(device))
    return _config_fingerprint(graph_fingerprint(g, h, tg, view), cfg, backend)


def validate_request(g: Graph, h: Hierarchy, cfg: SharedMapConfig,
                     view: HostView | None = None) -> None:
    """Reject malformed requests at the service boundary with a clear
    ``ValueError`` instead of an opaque scheduler-thread error surfacing
    through the Future (or worse, garbage output)."""
    v = view if view is not None else host_view(g)
    n, m = v.n, v.m
    if n <= 0:
        raise ValueError("empty graph: n=0 vertices (nothing to map)")
    if n > g.N or m > g.M:
        raise ValueError(f"graph counts exceed padded shapes: "
                         f"n={n} > N={g.N} or m={m} > M={g.M}")
    if h.k > n:
        raise ValueError(f"hierarchy needs k={h.k} PEs but the graph has "
                         f"only n={n} vertices (k > N is unmappable)")
    if m > 0:
        if int(v.rows.min()) < 0 or int(v.rows.max()) >= n \
                or int(v.cols.min()) < 0 or int(v.cols.max()) >= n:
            raise ValueError(f"edge endpoints out of range [0, {n}): "
                             "rows/cols reference padding or negative ids")
    if not (0.0 < float(cfg.eps) < 1.0):
        raise ValueError(f"imbalance eps must be in (0, 1), got {cfg.eps}")
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; "
                         f"expected one of {STRATEGIES}")
    if cfg.preset not in _PRESETS:
        raise ValueError(f"unknown preset {cfg.preset!r}; "
                         f"expected one of {_PRESETS}")


@dataclasses.dataclass(eq=False)  # identity equality: requests live in lists
class _Request:
    g: Graph
    h: Hierarchy
    cfg: SharedMapConfig
    fp: bytes
    gfp: bytes
    futures: list[Future]
    planner: LevelPlanner | None = None
    priority: int = 0
    deadline: float | None = None   # absolute time.monotonic()
    seq: int = 0
    started: bool = False           # counted in admission.inflight
    degradation: dict | None = None  # set when served below full quality
    view: HostView | None = None    # kept for a worker's payload only
    queued_ns: int = 0              # time.perf_counter_ns() when queued


def _dummy_host_graph(N: int, M: int):
    """A path graph filling the (N, M) padded shape, for warmup runs."""
    if N < 2 or M < 2:
        raise ValueError(f"warmup shape too small: N={N}, M={M}")
    e = max(min(N - 1, M // 2), 1)
    u = np.arange(e, dtype=np.int64)
    return host_graph_from(from_edges(N, u, u + 1, N=N, M=M, device="cpu"))


# Services alive at interpreter exit: fail their pending futures instead of
# leaking them when the daemon scheduler thread is killed mid-flight.
_LIVE_SERVICES: "weakref.WeakSet[MappingService]" = weakref.WeakSet()


@atexit.register
def _close_live_services() -> None:
    for svc in list(_LIVE_SERVICES):
        try:
            svc.close(wait=False)
        except Exception:
            pass


class MappingService:
    """Async mapping service: concurrent ``(Graph, Hierarchy, config)``
    requests, coalesced dispatches, LRU result cache, warmup, admission
    control, deadlines, fault containment, graceful degradation.

    Parameters
    ----------
    cache_entries: LRU bound of the result cache (0 disables caching).
    batch_window_s: how long the scheduler waits after a request arrives
        on an idle service before planning, so a concurrent burst lands in
        the same coalesced dispatches.
    merge_across_requests: dispatch same-``exec_key`` groups of different
        requests as one batch (False = per-request dispatches).
    pad_batch_pow2: count merged batches as padded to the next power of
        two (``stats()["coalesce"]["padded_lanes"]``), as the reference
        does to bound its compiled batch widths; the port runs no padded
        lane (see ``core.multisection.dispatch_group_batch``).
    fallback_workers: thread pool size for the non-plannable strategies,
        finalization, and degraded reruns.
    max_inflight: bound on concurrently ACTIVE requests (planners being
        stepped + fallback jobs); excess waits in the queue (backpressure).
    max_queue: bound on accepted-but-waiting requests; overflow is shed
        with :class:`ServiceOverloadError` (or preempts a lower-priority
        waiter, or degrades — see ``degrade_on_overload``).
    degrade_at: fraction of ``max_queue`` at which new arrivals are served
        degraded instead of full quality (only with ``degrade_on_overload``).
    degrade_on_overload: serve overflow along the quality ladder
        (cached-nearby → fast preset → greedy) instead of shedding it.
    degrade_on_failure: after transient-failure retries are exhausted,
        serve the request degraded instead of failing its Future (default
        on — deterministic errors always propagate regardless).
    retry: :class:`RetryPolicy` for transient dispatch/finalize failures.
    tracker: metrics sink (``serve/tracker.py``); sink errors never
        propagate into the serving path.
    fault_injector: seeded ``repro_torch.faults.FaultInjector`` exercised at
        the dispatch/cache/finalize seams and forwarded to the store
        (``store_write``) and supervisor (``worker_kill``) seams.
    validate: check requests at the boundary (``validate_request``) and
        raise ``ValueError`` synchronously from :meth:`submit`.
    store_path: directory for the crash-safe persistent result store
        (``serve/store.py``); None disables persistence. An LRU miss falls
        through to the store, so a restarted service with the same path
        warm-starts its cache bit-identically.
    store: an already-constructed :class:`ResultStore` (overrides
        ``store_path``; lets tests share one store between services).
    workers: > 0 executes requests in that many SUPERVISED WORKER
        PROCESSES (``serve/supervisor.py``) on this service's device
        instead of in-process: crashes (incl. SIGKILL) are detected,
        workers restart with capped backoff, in-flight requests are
        re-dispatched. Trades cross-request coalescing for crash isolation.
    worker_kwargs: extra keyword arguments for
        :class:`SupervisedWorkerPool` (heartbeat_s, hang_timeout_s, ...).
    shadow_verify_fraction: fraction (0..1) of ``strategy="device"``
        results re-executed against the bitwise host-mirror twin
        (``resident=False``). The first divergence quarantines the device
        strategy for the session (host path from then on), evicts the
        lying cache/store entry, and re-caches the trusted host result.
    device: where every request runs (None = the card; raises without
        one). Pass ``device="cpu"`` to serve from the plain versions.
    """

    def __init__(self, cache_entries: int = 256, batch_window_s: float = 0.002,
                 merge_across_requests: bool = True, pad_batch_pow2: bool = True,
                 fallback_workers: int = 2, max_inflight: int = 64,
                 max_queue: int = 512, degrade_at: float = 0.75,
                 degrade_on_overload: bool = False,
                 degrade_on_failure: bool = True,
                 retry: RetryPolicy | None = None,
                 tracker: Tracker = NULL_TRACKER,
                 fault_injector: FaultInjector = NULL_INJECTOR,
                 validate: bool = True,
                 store_path: str | None = None,
                 store: ResultStore | None = None,
                 workers: int = 0,
                 worker_kwargs: dict | None = None,
                 shadow_verify_fraction: float = 0.0,
                 device=None):
        self.device = resolve_device(device)
        self.cache_entries = int(cache_entries)
        self.batch_window_s = float(batch_window_s)
        self.merge_across_requests = bool(merge_across_requests)
        self.pad_batch_pow2 = bool(pad_batch_pow2)
        self.degrade_on_overload = bool(degrade_on_overload)
        self.degrade_on_failure = bool(degrade_on_failure)
        self.validate = bool(validate)
        self.retry = retry or RetryPolicy()
        self.tracker = tracker
        self.faults = fault_injector
        self.store = store
        if self.store is None and store_path is not None:
            self.store = ResultStore(store_path, fault_injector=fault_injector)
        self.supervisor: SupervisedWorkerPool | None = None
        if int(workers) > 0:
            self.supervisor = SupervisedWorkerPool(
                int(workers), device=self.device, fault_injector=fault_injector,
                tracker=tracker, **(worker_kwargs or {}))
        self.shadow_verify_fraction = float(shadow_verify_fraction)
        self._shadow_seq = 0
        self._device_quarantined = False
        self.admission = AdmissionController(max_inflight=max_inflight,
                                             max_queue=max_queue,
                                             degrade_at=degrade_at)
        self._cv = threading.Condition()
        self._queue: list[_Request] = []
        self._pending: dict[bytes, _Request] = {}  # queued + active, by fp
        self._seq = 0
        self._closed = False
        self._abort = False
        self._thread: threading.Thread | None = None
        self._fallback = ThreadPoolExecutor(
            max_workers=max(1, fallback_workers),
            thread_name_prefix="mapper-fallback")
        self._cache: OrderedDict[bytes, SharedMapResult] = OrderedDict()
        self._by_graph: dict[bytes, bytes] = {}  # gfp -> freshest cached fp
        self._lock = threading.Lock()  # cache + telemetry
        self.telemetry = {
            "requests": 0,
            "inflight_dedup": 0,
            "result_cache": {"hits": 0, "misses": 0, "evictions": 0},
            "coalesce": {"dispatches": 0, "groups": 0, "members": 0,
                         "padded_lanes": 0},
            "warmup": {"programs": 0, "seconds": 0.0},
            "faults": {"dispatch_failures": 0, "retries": 0, "isolated": 0,
                       "contained": 0, "cache_faults": 0, "degraded": 0},
            "shadow": {"sampled": 0, "matched": 0, "mismatched": 0},
        }
        _LIVE_SERVICES.add(self)

    def _request_fp(self, gfp: bytes, cfg: SharedMapConfig) -> bytes:
        return _config_fingerprint(gfp, cfg, resolve_backend(cfg.backend, self.device))

    # ------------------------------------------------------------- frontend

    def submit(self, g: Graph | TaskGraph, h: Hierarchy,
               config: SharedMapConfig | None = None, *,
               priority: int = 0, deadline_s: float | None = None,
               on_shed: str = "raise") -> Future:
        """Enqueue a mapping request; returns a Future[SharedMapResult].

        The graph is moved to the service's device first (a TaskGraph
        through its memoized ``to_graph(device=...)``).
        ``priority``: larger = more important; under a full queue a
        higher-priority arrival preempts the lowest-priority waiter.
        ``deadline_s``: relative deadline; the request is cancelled with
        :class:`DeadlineExceededError` if still queued — or between
        multisection levels — once it expires.
        ``on_shed``: "raise" surfaces :class:`ServiceOverloadError`
        synchronously; "future" returns it on the Future instead (what
        :meth:`submit_many` uses so one shed cannot poison a batch).

        Raises ``ValueError`` synchronously for malformed inputs (empty
        graph, k > n, out-of-range edges, bad eps/strategy/preset) and
        :class:`ServiceClosedError` after :meth:`close`.
        """
        with spans.span("service.submit") as sp:
            return self._submit(g, h, config, priority, deadline_s, on_shed, sp)

    def _submit(self, g, h, config, priority, deadline_s, on_shed, sp) -> Future:
        cfg = config or SharedMapConfig()
        tg = g if isinstance(g, TaskGraph) else None
        g = tg.to_graph(device=self.device) if tg is not None else g.to(self.device)
        view = host_view(g)
        if self.validate:
            validate_request(g, h, cfg, view)
        fut: Future = Future()
        deadline = None
        if deadline_s is not None:
            deadline = time.monotonic() + float(deadline_s)
        gfp = graph_fingerprint(g, h, tg, view)
        fp = self._request_fp(gfp, cfg)
        cached = self._cache_get(fp)
        if cached is not None:
            fut.set_result(self._result_copy(cached, cache_hit=True))
            return fut
        with self._lock:
            self.telemetry["requests"] += 1
            self.telemetry["result_cache"]["misses"] += 1
        safe_emit(self.tracker.count, "service.cache.miss")
        if deadline is not None and deadline <= time.monotonic():
            self._count_deadline_miss()
            fut.set_exception(DeadlineExceededError(
                f"deadline of {deadline_s}s already expired at submit"))
            return fut
        with self._cv:
            if self._closed:
                raise ServiceClosedError("MappingService is closed")
            inflight = self._pending.get(fp)
            if inflight is not None:
                # identical request already queued/active: one computation
                inflight.futures.append(fut)
                with self._lock:
                    self.telemetry["inflight_dedup"] += 1
                return fut
            return self._admit_new(g, h, cfg, fp, gfp, fut, priority, deadline,
                                   on_shed, view, sp)

    def _admit_new(self, g, h, cfg, fp, gfp, fut, priority, deadline,
                   on_shed, view, sp) -> Future:
        """Admission decision for a non-cached, non-dedup request. Caller
        holds ``_cv``; ``sp`` is the submit's span, given the request's
        ``seq`` once it is queued."""
        adm = self.admission
        waiting = min(((r.priority, -r.seq) for r in self._queue),
                      default=None)
        decision = adm.decide(priority, waiting[0] if waiting else None,
                              degrade_ok=self.degrade_on_overload)
        degradation = None
        if decision == PREEMPT:
            victim = min(self._queue, key=lambda r: (r.priority, -r.seq))
            self._queue.remove(victim)
            adm.note_dequeued()
            adm.note_shed(preempted=True)
            safe_emit(self.tracker.count, "service.preempted")
            safe_emit(self.tracker.event, "shed", reason="preempted",
                      priority=victim.priority, by_priority=priority)
            self._fail(victim, ServiceOverloadError(
                "preempted by a higher-priority request",
                queued=adm.queued, inflight=adm.inflight))
            decision = ADMIT_DEGRADED if (
                self.degrade_on_overload
                and adm.queued >= adm.soft_bound()) else ADMIT
        if decision == SHED:
            if self.degrade_on_overload:
                return self._serve_inline_degraded(g, h, cfg, fut, "overload", gfp)
            adm.note_shed()
            safe_emit(self.tracker.count, "service.shed")
            safe_emit(self.tracker.event, "shed", reason="queue_full",
                      queued=adm.queued, inflight=adm.inflight)
            exc = ServiceOverloadError(
                f"mapping queue full ({adm.queued} waiting, "
                f"{adm.inflight} in flight); request shed",
                queued=adm.queued, inflight=adm.inflight,
                retry_after_s=0.05 * max(adm.queued, 1))
            if on_shed == "raise":
                raise exc
            fut.set_exception(exc)
            return fut
        if decision == ADMIT_DEGRADED and cfg.preset != "fast":
            # soft overload: trade quality for queue drain speed — the
            # request is served with the cheapest preset, cached under the
            # DEGRADED config's fingerprint (never the original's).
            cfg = dataclasses.replace(cfg, preset="fast")
            fp = self._request_fp(gfp, cfg)
            degradation = {"level": DEGRADE_FAST_PRESET,
                           "mode": "fast_preset", "reason": "overload"}
            adm.note_degraded()
            self._count_fault("degraded")
            safe_emit(self.tracker.count, "service.degraded",
                      mode="fast_preset")
            cached = self._cache_get(fp)
            if cached is not None:
                fut.set_result(self._result_copy(cached, cache_hit=True,
                                                 degradation=degradation))
                return fut
            dedup = self._pending.get(fp)
            if dedup is not None:
                dedup.futures.append(fut)
                return fut
        self._seq += 1
        sp.set(req=self._seq)
        req = _Request(g=g, h=h, cfg=cfg, fp=fp, gfp=gfp, futures=[fut],
                       priority=priority, deadline=deadline, seq=self._seq,
                       degradation=degradation,
                       view=view if self.supervisor is not None else None,
                       queued_ns=time.perf_counter_ns())
        self._pending[fp] = req
        self._queue.append(req)
        adm.note_queued()
        safe_emit(self.tracker.count, "service.admitted")
        self._ensure_thread()
        self._cv.notify_all()
        return fut

    def submit_many(self, requests, *, priority: int = 0,
                    deadline_s: float | None = None) -> list[Future]:
        """Atomically enqueue a burst of ``(g, h, config)`` requests.

        All of them are admitted in ONE scheduler iteration, so the merged
        batch compositions are deterministic for a given burst —
        independent of caller timing.

        Per-request failures (validation errors, shed requests) come back
        as failed Futures instead of raising, so one bad or shed request
        never poisons its siblings in the batch.
        """
        futs = []
        with self._cv:  # Condition wraps an RLock: nested submit is fine
            for (g, h, cfg) in requests:
                try:
                    futs.append(self.submit(g, h, cfg, priority=priority,
                                            deadline_s=deadline_s,
                                            on_shed="future"))
                except Exception as exc:
                    f: Future = Future()
                    f.set_exception(exc)
                    futs.append(f)
        return futs

    def map(self, g: Graph | TaskGraph, h: Hierarchy,
            config: SharedMapConfig | None = None, *,
            priority: int = 0,
            deadline_s: float | None = None) -> SharedMapResult:
        """Blocking request (the ``shared_map`` route when installed)."""
        return self.submit(g, h, config, priority=priority,
                           deadline_s=deadline_s).result()

    async def amap(self, g: Graph | TaskGraph, h: Hierarchy,
                   config: SharedMapConfig | None = None, *,
                   priority: int = 0,
                   deadline_s: float | None = None) -> SharedMapResult:
        """Asyncio request."""
        return await asyncio.wrap_future(
            self.submit(g, h, config, priority=priority,
                        deadline_s=deadline_s))

    # -------------------------------------------------------------- warmup

    def warmup(self, shapes, ks, preset: str = "eco", backend: str = "auto",
               eps: float = 0.03, batch_sizes=(1, 2, 4, 8),
               ell_degs=None) -> dict:
        """Prepare the service for the expected traffic.

        There is no program cache to fill. On the card this builds and
        loads the kernel library (``nvcc`` at first use), then runs each
        (shape, k, ELL cap, batch) group once, so that the caching
        allocator holds its blocks. ``shapes``: (N, M) padded bucket shapes
        (powers of two, as the bucket scheduler produces); ``ks``:
        sub-partition arities; ``batch_sizes``: coalesced batch widths to
        cover. ``ell_degs`` optionally pins the ELL degree caps to run for
        the ``ell`` backend (default: derived from the dummy graph; ``xla``
        takes none). Returns ``{"programs", "seconds"}``, the reference's
        count for the same arguments.
        """
        backend = resolve_backend(backend, self.device)
        t0 = time.perf_counter_ns()
        if self.device.type == "cuda":
            from ..kernels import _build
            _build.library()
        programs = 0
        for (N, M) in shapes:
            hg = _dummy_host_graph(int(N), int(M))
            degs = tuple(ell_degs) if ell_degs is not None \
                else (_ell_deg_for([hg], backend),)
            for k in ks:
                lv = num_levels(int(N), int(k))
                for deg in degs:
                    for B in batch_sizes:
                        gr = PlanGroup(
                            members=[hg] * int(B), N=int(N), M=int(M),
                            arity=int(k), levels=lv, preset=preset,
                            backend=backend, deg=deg,
                            eps=[float(eps)] * int(B),
                            salts=list(range(int(B))))
                        execute_group_batch([gr], self.device)
                        programs += 1
        dt = (time.perf_counter_ns() - t0) / 1e9
        with self._lock:
            self.telemetry["warmup"]["programs"] += programs
            self.telemetry["warmup"]["seconds"] += dt
        return {"programs": programs, "seconds": dt}

    # ---------------------------------------------------------- install / cm

    def install(self) -> "MappingService":
        """Route ``core.api.shared_map`` through this service."""
        capi.install_service(self)
        return self

    def uninstall(self) -> None:
        if capi.current_service() is self:
            capi.install_service(None)

    @contextmanager
    def installed(self):
        prev = capi.install_service(self)
        try:
            yield self
        finally:
            capi.install_service(prev)

    def close(self, wait: bool = True) -> None:
        """Stop the service. ``wait=True`` drains: every accepted request
        completes before return. ``wait=False`` aborts: every still-pending
        Future is failed with :class:`ServiceClosedError` BEFORE this
        returns (nothing leaks), and in-flight pipelines are cancelled at
        their next cooperative checkpoint."""
        with self._cv:
            self._closed = True
            if not wait:
                self._abort = True
            self._cv.notify_all()
        if not wait:
            self._fail_pending(ServiceClosedError(
                "MappingService closed before the request completed"))
        if self._thread is not None:
            self._thread.join(None if wait else 2.0)
        if self.supervisor is not None:
            # drain (or abort) the worker processes BEFORE the fallback
            # pool: worker done-callbacks may still submit finalize/shadow
            # jobs onto it.
            self.supervisor.close(wait=wait)
        self._fallback.shutdown(wait=wait, cancel_futures=not wait)
        self.uninstall()
        _LIVE_SERVICES.discard(self)
        safe_emit(self.tracker.flush)

    def _fail_pending(self, exc: BaseException) -> None:
        """Synchronously fail every accepted-but-unresolved request (the
        close(wait=False) / interpreter-teardown path)."""
        with self._cv:
            doomed = list(self._pending.values())
            for _ in self._queue:
                self.admission.note_dequeued()
            self._queue.clear()
        for req in doomed:
            self._fail(req, exc)

    def __enter__(self) -> "MappingService":
        return self.install()

    def __exit__(self, exc_type, *exc) -> None:
        self.uninstall()
        # deterministic teardown: a clean exit drains (every Future
        # resolves with its result); an exception exit aborts (every
        # pending Future fails with ServiceClosedError, promptly).
        self.close(wait=exc_type is None)

    def stats(self) -> dict:
        """Snapshot of the service telemetry."""
        with self._lock:
            snap = {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in self.telemetry.items()}
            snap["result_cache"]["entries"] = len(self._cache)
            snap["result_cache"]["capacity"] = self.cache_entries
            snap["shadow"]["device_quarantined"] = self._device_quarantined
        with self._cv:
            snap["admission"] = self.admission.snapshot()
        if self.store is not None:
            snap["store"] = self.store.stats()
        if self.supervisor is not None:
            snap["workers"] = self.supervisor.stats()
        # aggregation sinks (e.g. CounterTracker) also get the level-style
        # instruments counters can't carry, and their aggregated view rides
        # along in the snapshot — probed with getattr so plain count/event
        # sinks stay valid.
        gauge = getattr(self.tracker, "gauge", None)
        if callable(gauge):
            adm = snap["admission"]
            safe_emit(gauge, "service.queue_depth", adm["queued"])
            safe_emit(gauge, "service.inflight", adm["inflight"])
            safe_emit(gauge, "service.cache_entries",
                      snap["result_cache"]["entries"])
        tsnap = getattr(self.tracker, "snapshot", None)
        if callable(tsnap):
            try:
                snap["tracker"] = tsnap()
            except Exception:
                pass
        return snap

    # ------------------------------------------------------------ scheduler

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="mapper-scheduler")
            self._thread.start()

    def _queue_wait_timeout(self) -> float | None:
        """Sleep bound while parked: wake for the earliest queued deadline."""
        deadlines = [r.deadline for r in self._queue if r.deadline is not None]
        if not deadlines:
            return None
        return max(min(deadlines) - time.monotonic(), 0.0)

    def _sweep_expired_queue(self) -> None:
        """Fail queued requests past their deadline. Caller holds ``_cv``."""
        now = time.monotonic()
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        for req in expired:
            self._queue.remove(req)
            self.admission.note_dequeued()
            self._deadline_miss(req)

    def _take_admissible(self) -> list[_Request]:
        """Move queued requests into the in-flight set up to the bound,
        highest priority (FIFO within a priority) first. Holds ``_cv``."""
        self._sweep_expired_queue()
        self._queue.sort(key=lambda r: (-r.priority, r.seq))
        taken = []
        now = time.perf_counter_ns()
        while self._queue and self.admission.has_capacity():
            req = self._queue.pop(0)
            self.admission.note_dequeued()
            self.admission.note_start()
            req.started = True
            spans.record("service.queue", req.queued_ns, now, req=req.seq)
            taken.append(req)
        return taken

    def _loop(self) -> None:
        active: list[_Request] = []
        while True:
            with self._cv:
                while True:
                    self._sweep_expired_queue()
                    if self._abort:
                        # close(wait=False) already failed every pending
                        # Future; just drop the in-flight state.
                        return
                    if self._closed and not self._queue and not active:
                        return
                    if active or (self._queue
                                  and self.admission.has_capacity()):
                        break
                    self._cv.wait(self._queue_wait_timeout()
                                  if self._queue else None)
                newly = self._take_admissible()
            if newly and not active and self.batch_window_s > 0:
                # idle service: hold the first arrivals briefly so a
                # concurrent burst coalesces from level 0 on.
                with spans.span("service.batch_window"):
                    time.sleep(self.batch_window_s)
                with self._cv:
                    newly += self._take_admissible()
            for req in newly:
                try:
                    with spans.span("service.admit", req=req.seq):
                        self._admit(req, active)
                except BaseException as exc:  # fail fast, never hang callers
                    self._fail(req, exc)
            if active:
                try:
                    with spans.span("service.round") as rnd:
                        members, dispatches = self._step(active)
                        rnd.set(members=members, dispatches=dispatches)
                except BaseException as exc:
                    # last-resort containment: _step already isolates
                    # per-request failures, so reaching here means the
                    # round itself broke — fail its requests, keep serving.
                    for req in active:
                        self._contain(req, exc)
                    active.clear()

    def _planner_checkpoint(self, req: _Request) -> None:
        """Cooperative cancellation hook run between multisection levels."""
        if self._abort:
            raise ServiceClosedError("service aborted mid-pipeline")
        if req.deadline is not None and time.monotonic() > req.deadline:
            raise DeadlineExceededError("deadline exceeded mid-pipeline")

    def _admit(self, req: _Request, active: list[_Request]) -> None:
        if self.supervisor is not None:
            # worker mode: the whole request executes in a supervised
            # process — crash isolation supersedes coalescing.
            self._submit_to_worker(req)
            return
        if req.cfg.strategy in _PLANNABLE:
            try:
                req.planner = LevelPlanner(
                    req.g, req.h, eps=req.cfg.eps, preset=req.cfg.preset,
                    seed=req.cfg.seed, adaptive=req.cfg.adaptive,
                    backend=req.cfg.backend, strategy=req.cfg.strategy,
                    resident=self._resident_override(req.cfg),
                    checkpoint=lambda req=req: self._planner_checkpoint(req),
                    req=req.seq)
            except BaseException as exc:
                self._fail(req, exc)
                return
            active.append(req)
        else:
            self._fallback.submit(self._run_fallback, req)

    def _resident_override(self, cfg: SharedMapConfig) -> bool | None:
        """None = the strategy's default; False = host-mirror twin, forced
        once the shadow verifier has quarantined the device pipeline."""
        if cfg.strategy == "device" and self._device_quarantined:
            return False
        return None

    def _step(self, active: list[_Request]) -> tuple[int, int]:
        """One coalesced execution round over all active planners; returns
        the lanes and the dispatches it ran.

        Failure containment: planning, dispatch and advance are guarded
        per request or per merged set; a failure removes only the requests
        it belongs to — the round (and the scheduler thread) survives.
        """
        now = time.monotonic()
        for req in list(active):  # mid-pipeline deadline cancellation
            if req.deadline is not None and now > req.deadline:
                active.remove(req)
                self._deadline_miss(req)
        plans = []
        for req in list(active):
            try:
                plans.append((req, req.planner.plan()))
            except BaseException as exc:
                active.remove(req)
                self._contain(req, exc)
        merged: OrderedDict[tuple, list[tuple[_Request, int, PlanGroup]]] = \
            OrderedDict()
        for req, groups in plans:
            for gi, gr in enumerate(groups):
                merged.setdefault(gr.exec_key, []).append((req, gi, gr))
        # dispatch ALL merged sets before fetching any, as the reference
        # does: kernels queue on the device's stream.
        inflight = []
        round_lanes = round_dispatches = 0
        for entries in merged.values():
            groups = [e[2] for e in entries]
            members = sum(len(gr.members) for gr in groups)
            try:
                with spans.span("service.dispatch", lanes=members):
                    self.faults.check("dispatch")
                    if self.merge_across_requests:
                        handles = [dispatch_group_batch(
                            groups, self.device, pad_batch_pow2=self.pad_batch_pow2)]
                        dispatches = 1
                    else:
                        handles = [dispatch_group_batch([gr], self.device)
                                   for gr in groups]
                        dispatches = len(groups)
            except BaseException as exc:
                inflight.append((entries, None, exc))
                continue
            inflight.append((entries, handles, None))
            round_lanes += members
            round_dispatches += dispatches
            with self._lock:
                co = self.telemetry["coalesce"]
                co["dispatches"] += dispatches
                co["groups"] += len(groups)
                co["members"] += members
                if self.merge_across_requests and self.pad_batch_pow2:
                    co["padded_lanes"] += _next_pow2(members) - members
        results: dict[tuple[int, int], object] = {}
        for entries, handles, exc in inflight:
            if exc is None:
                try:
                    outs = [o for hd in handles for o in fetch_group_batch(hd)]
                    for (req, gi, _), out in zip(entries, outs):
                        results[(id(req), gi)] = out
                    continue
                except BaseException as fetch_exc:
                    exc = fetch_exc
            # the merged dispatch failed: isolate — re-run each request's
            # group alone so one poisoned member cannot fail its siblings.
            self._count_fault("dispatch_failures")
            safe_emit(self.tracker.event, "dispatch_failure",
                      error=repr(exc), members=len(entries))
            results.update(self._execute_isolated(entries))
        finished = []
        for req, groups in plans:
            if req not in active:
                continue
            outs = [results.get((id(req), gi)) for gi in range(len(groups))]
            errs = [o for o in outs if isinstance(o, BaseException)]
            if errs:
                active.remove(req)
                self._contain(req, errs[0])
                continue
            try:
                req.planner.advance(outs)
                if not req.planner.plan():
                    finished.append(req)
            except BaseException as exc:
                active.remove(req)
                self._contain(req, exc)
        for req in finished:
            active.remove(req)
            # finalize (evaluate_J, cache insert, future resolution) on the
            # worker pool: it overlaps the next levels' dispatches instead
            # of serializing behind them in the scheduler thread.
            self._fallback.submit(self._finalize_job, req, req.planner.result())
        return round_lanes, round_dispatches

    def _execute_isolated(self, entries) -> dict:
        """Solo re-execution of each (request, group) from a failed merged
        dispatch, with transient-failure retries. Maps (id(req), gi) to a
        result array or the terminal exception."""
        with self._lock:
            self.telemetry["faults"]["isolated"] += len(entries)
        out: dict[tuple[int, int], object] = {}
        for (req, gi, gr) in entries:
            try:
                out[(id(req), gi)] = self._execute_with_retry(
                    gr, deadline=req.deadline)
            except BaseException as exc:
                out[(id(req), gi)] = exc
        return out

    def _execute_with_retry(self, gr: PlanGroup, deadline: float | None = None):
        """One group's dispatch with the retry policy: transient failures
        back off exponentially up to ``retry.max_retries``; deterministic
        failures raise immediately (retrying them cannot help).

        Each backoff sleep is capped at the request's remaining deadline
        budget and the deadline is re-checked before re-dispatching, so a
        retrying request can never resolve LATE — it fails with
        ``DeadlineExceededError`` the moment the budget runs out.
        """
        attempt = 0
        while True:
            try:
                self.faults.check("dispatch")
                return execute_group_batch([gr], self.device)[0]
            except BaseException as exc:
                if not self.retry.is_transient(exc) \
                        or attempt >= self.retry.max_retries:
                    raise
                backoff = self.retry.backoff_s(attempt, deadline=deadline)
                self._count_fault("retries")
                safe_emit(self.tracker.count, "service.retry")
                safe_emit(self.tracker.event, "retry", attempt=attempt,
                          backoff_s=backoff, error=repr(exc))
                time.sleep(backoff)
                if deadline is not None and time.monotonic() > deadline:
                    raise DeadlineExceededError(
                        "deadline exceeded during retry backoff") from exc
                attempt += 1

    # ------------------------------------------------- fallback / finalize

    def _run_fallback(self, req: _Request) -> None:
        attempt = 0
        while True:
            try:
                self._planner_checkpoint(req)  # deadline/abort before start
                self.faults.check("dispatch")
                res = capi.shared_map_direct(
                    req.g, req.h, req.cfg,
                    checkpoint=lambda: self._planner_checkpoint(req),
                    device=self.device)
                self._resolve(req, res)
                return
            except BaseException as exc:
                if isinstance(exc, (DeadlineExceededError,
                                    ServiceClosedError)):
                    self._contain(req, exc)
                    return
                if self.retry.is_transient(exc) \
                        and attempt < self.retry.max_retries:
                    self._count_fault("retries")
                    safe_emit(self.tracker.count, "service.retry")
                    # capped at the deadline budget; the loop's checkpoint
                    # turns an exhausted budget into DeadlineExceededError
                    # before any re-dispatch.
                    time.sleep(self.retry.backoff_s(attempt,
                                                    deadline=req.deadline))
                    attempt += 1
                    continue
                self._contain(req, exc)
                return

    def _finalize_job(self, req: _Request, ms_result) -> None:
        with spans.span("service.finalize", req=req.seq):
            try:
                self.faults.check("finalize")
                self._finalize(req, ms_result)
            except BaseException as exc:
                self._contain(req, exc)

    def _finalize(self, req: _Request, ms_result) -> None:
        pe_of = capi.finalize_mapping(req.g, req.h, req.cfg,
                                      ms_result.pe_of, ms_result.stats)
        res = SharedMapResult(pe_of=pe_of,
                              J=evaluate_J(req.g, req.h, pe_of, device=self.device),
                              stats=ms_result.stats)
        self._resolve(req, res)
        self._maybe_shadow(req, res)

    # ------------------------------------------------- supervised workers

    def _submit_to_worker(self, req: _Request) -> None:
        """Ship one request to the supervised worker pool as plain numpy
        arrays (the real CSR slices of the request's host view — padding is
        rebuilt worker-side, on the device named in the payload; no CUDA
        tensor crosses the process boundary). The deadline crosses as a
        REMAINING duration: monotonic instants are not comparable between
        processes."""
        v = req.view
        timeout_s = None
        if req.deadline is not None:
            timeout_s = max(req.deadline - time.monotonic(), 0.0)
        payload = {
            "vwgt": v.vwgt, "rows": v.rows, "cols": v.cols, "ewgt": v.ewgt,
            "n": v.n, "N": int(req.g.N), "M": int(req.g.M),
            "a": tuple(req.h.a), "d": tuple(req.h.d),
            "cfg": dataclasses.asdict(req.cfg),
            "timeout_s": timeout_s,
            "resident": self._resident_override(req.cfg),
            "device": str(self.device),
        }
        req.view = None   # the payload holds the arrays now
        try:
            fut = self.supervisor.submit(
                "repro_torch.serve.supervisor:mapping_task", payload)
        except BaseException as exc:
            self._fail(req, exc)
            return
        fut.add_done_callback(
            lambda f, req=req: self._worker_done(req, f))

    def _worker_done(self, req: _Request, fut: Future) -> None:
        """Worker completion (runs on the supervisor's collector thread).
        Crash errors are transient (``WorkerCrashError.transient``) and
        fall into the normal containment/degradation ladder."""
        try:
            out = fut.result()
        except BaseException as exc:
            self._contain(req, exc)
            return
        try:
            if req.deadline is not None and time.monotonic() > req.deadline:
                self._deadline_miss(req)
                return
            res = SharedMapResult(pe_of=np.asarray(out["pe_of"]),
                                  J=float(out["J"]),
                                  stats=dict(out["stats"]))
            self._resolve(req, res)
            self._maybe_shadow(req, res)
        except BaseException as exc:
            self._fail(req, exc)

    # ---------------------------------------------------- shadow verification

    def _maybe_shadow(self, req: _Request, res: SharedMapResult) -> None:
        """Deterministically sample device-strategy results for re-execution
        against the bitwise host-mirror twin (``resident=False``)."""
        if (self.shadow_verify_fraction <= 0.0
                or req.cfg.strategy != "device"
                or self._device_quarantined
                or req.degradation is not None):
            return
        with self._lock:
            self._shadow_seq += 1
            draw = _hash_uniform(getattr(self.faults, "seed", 0) or 0,
                                 "shadow", self._shadow_seq - 1)
        if draw >= self.shadow_verify_fraction:
            return
        try:
            self._fallback.submit(self._shadow_verify, req, res)
        except RuntimeError:
            # pool already shutting down (close raced the sampling): verify
            # inline so a sampled result is never silently dropped.
            self._shadow_verify(req, res)

    def _shadow_verify(self, req: _Request, res: SharedMapResult) -> None:
        """Re-execute on the host-mirror twin and compare bitwise. Runs on
        the fallback pool AFTER the caller's Future resolved — verification
        costs latency only for the sampled fraction's *successors* (the
        quarantine decision), never for the sampled request itself."""
        with self._lock:
            self.telemetry["shadow"]["sampled"] += 1
        try:
            ref = capi.shared_map_direct(req.g, req.h, req.cfg,
                                         resident=False, device=self.device)
        except BaseException as exc:  # the twin failing is not a divergence
            safe_emit(self.tracker.event, "shadow_error", error=repr(exc))
            return
        if np.array_equal(np.asarray(res.pe_of), np.asarray(ref.pe_of)):
            with self._lock:
                self.telemetry["shadow"]["matched"] += 1
            safe_emit(self.tracker.count, "service.shadow.match")
            return
        self._shadow_mismatch(req, ref)

    def _shadow_mismatch(self, req: _Request, ref: SharedMapResult) -> None:
        """First divergence: quarantine the device strategy for the session,
        evict + quarantine the lying entry, re-cache the trusted host
        result under the same fingerprint."""
        with self._lock:
            self.telemetry["shadow"]["mismatched"] += 1
            self._device_quarantined = True
            self._cache.pop(req.fp, None)
            if self._by_graph.get(req.gfp) == req.fp:
                self._by_graph.pop(req.gfp, None)
        safe_emit(self.tracker.count, "service.shadow.mismatch")
        safe_emit(self.tracker.event, "shadow_mismatch", fp=req.fp.hex(),
                  strategy_quarantined="device")
        if self.store is not None:
            self.store.quarantine(req.fp, reason="shadow_mismatch")
        self._cache_put(req.fp, req.gfp, ref)

    # -------------------------------------------- containment / degradation

    def _contain(self, req: _Request, exc: BaseException) -> None:
        """Terminal failure handler for one request: degrade transient
        failures down the quality ladder (when enabled), propagate typed
        errors for everything else. Never raises."""
        if isinstance(exc, (DeadlineExceededError, ServiceClosedError)):
            self._fail(req, exc)
            return
        self._count_fault("contained")
        if self.degrade_on_failure and self.retry.is_transient(exc):
            self._fallback.submit(self._run_degraded, req, exc)
            return
        self._fail(req, exc)

    def _greedy_result(self, g: Graph, h: Hierarchy,
                       cfg: SharedMapConfig) -> SharedMapResult:
        """The ladder's floor: the greedy baseline on the service's device."""
        pe_of = greedy_baseline(g, h, seed=cfg.seed, device=self.device)
        return SharedMapResult(
            pe_of=pe_of, J=evaluate_J(g, h, pe_of, device=self.device),
            stats={"strategy": "greedy_baseline",
                   "backend": resolve_backend(cfg.backend, self.device)})

    def _run_degraded(self, req: _Request, cause: BaseException) -> None:
        """Serve ``req`` down the quality ladder after its full-quality
        pipeline failed: cached-nearby → fast preset → greedy floor."""
        try:
            res = self._nearby_cached(req.gfp)
            if res is not None:
                self._resolve_degraded(req, res, DEGRADE_CACHED_NEARBY,
                                       "cached_nearby", cause)
                return
            if req.cfg.preset != "fast":
                try:
                    self.faults.check("dispatch")
                    res = capi.shared_map_direct(
                        req.g, req.h,
                        dataclasses.replace(req.cfg, preset="fast"),
                        checkpoint=lambda: self._planner_checkpoint(req),
                        device=self.device)
                    self._resolve_degraded(req, res, DEGRADE_FAST_PRESET,
                                           "fast_preset", cause)
                    return
                except (DeadlineExceededError, ServiceClosedError) as exc:
                    self._fail(req, exc)
                    return
                except BaseException:
                    pass  # keep falling down the ladder
            res = self._greedy_result(req.g, req.h, req.cfg)
            self._resolve_degraded(req, res, DEGRADE_GREEDY, "greedy", cause)
        except BaseException as exc:  # even the floor failed: typed error out
            self._fail(req, exc)

    def _resolve_degraded(self, req: _Request, res: SharedMapResult,
                          level: int, mode: str,
                          cause: BaseException) -> None:
        req.degradation = {"level": level, "mode": mode, "reason": "failure",
                           "cause": repr(cause)}
        self.admission.note_degraded()
        self._count_fault("degraded")
        safe_emit(self.tracker.count, "service.degraded", mode=mode)
        safe_emit(self.tracker.event, "degraded", mode=mode,
                  cause=repr(cause))
        # degraded answers are never cached: a later identical request must
        # get the full-quality result, not a frozen emergency one.
        self._resolve(req, res, cache=False)

    def _serve_inline_degraded(self, g, h, cfg, fut: Future, reason: str,
                               gfp: bytes) -> Future:
        """Hard-overload degradation, answered in the caller's thread (no
        queue slot consumed): cached-nearby if available, else the greedy
        floor. Caller holds ``_cv``."""
        adm = self.admission
        adm.note_degraded()
        self._count_fault("degraded")
        res = self._nearby_cached(gfp)
        if res is not None:
            level, mode = DEGRADE_CACHED_NEARBY, "cached_nearby"
        else:
            res = self._greedy_result(g, h, cfg)
            level, mode = DEGRADE_GREEDY, "greedy"
        safe_emit(self.tracker.count, "service.degraded", mode=mode)
        safe_emit(self.tracker.event, "degraded", mode=mode, reason=reason)
        fut.set_result(self._result_copy(
            res, cache_hit=(level == DEGRADE_CACHED_NEARBY),
            degradation={"level": level, "mode": mode, "reason": reason}))
        return fut

    def _deadline_miss(self, req: _Request) -> None:
        self._count_deadline_miss()
        self._fail(req, DeadlineExceededError(
            "deadline exceeded before the mapping completed"))

    def _count_deadline_miss(self) -> None:
        with self._cv:
            self.admission.note_deadline_miss()
        safe_emit(self.tracker.count, "service.deadline_miss")

    def _count_fault(self, name: str) -> None:
        with self._lock:
            self.telemetry["faults"][name] += 1

    # ------------------------------------------------------- future plumbing

    def _resolve(self, req: _Request, res: SharedMapResult,
                 cache: bool = True) -> None:
        if cache:
            self._cache_put(req.fp, req.gfp, res)
        self._finish_bookkeeping(req)
        for fut in req.futures:
            if not fut.done():  # a caller may have cancelled its Future
                fut.set_result(self._result_copy(
                    res, cache_hit=False, degradation=req.degradation))

    def _fail(self, req: _Request, exc: BaseException) -> None:
        self._finish_bookkeeping(req)
        for fut in req.futures:
            if not fut.done():
                fut.set_exception(exc)

    def _finish_bookkeeping(self, req: _Request) -> None:
        with self._cv:
            self._pending.pop(req.fp, None)
            if req.started:
                req.started = False
                self.admission.note_done()
            self._cv.notify_all()  # capacity freed: wake the scheduler

    # ---------------------------------------------------------- result cache

    def _cache_get(self, fp: bytes) -> SharedMapResult | None:
        if self.cache_entries <= 0 and self.store is None:
            return None
        try:
            self.faults.check("cache")
        except BaseException:  # contained: an injected cache fault = a miss
            self._count_fault("cache_faults")
            return None
        with self._lock:
            res = self._cache.get(fp)
            if res is not None:
                self._cache.move_to_end(fp)
                self.telemetry["requests"] += 1
                self.telemetry["result_cache"]["hits"] += 1
        if res is None and self.store is not None:
            # LRU miss: fall through to the persistence tier. The store
            # verifies the checksum — a corrupt entry is quarantined store-
            # side and surfaces here as a plain miss, never as a result.
            loaded = self.store.get(fp)
            if loaded is not None:
                res, gfp = loaded
                self._cache_insert(fp, gfp, res)
                with self._lock:
                    self.telemetry["requests"] += 1
                    self.telemetry["result_cache"]["hits"] += 1
                safe_emit(self.tracker.count, "service.store.hit")
        if res is not None:
            safe_emit(self.tracker.count, "service.cache.hit")
        return res

    def _cache_put(self, fp: bytes, gfp: bytes, res: SharedMapResult) -> None:
        if self.cache_entries <= 0 and self.store is None:
            return
        try:
            self.faults.check("cache")
        except BaseException:  # contained: the request still resolves
            self._count_fault("cache_faults")
            return
        self._cache_insert(fp, gfp, res)
        if self.store is not None:
            # persistence is a tier, not a requirement: put() swallows I/O
            # errors (counted in stats["store"]["write_errors"]).
            self.store.put(fp, gfp, res)

    def _cache_insert(self, fp: bytes, gfp: bytes,
                      res: SharedMapResult) -> None:
        """LRU insert only (no persistence side effects)."""
        if self.cache_entries <= 0:
            return
        with self._lock:
            self._cache[fp] = res
            self._cache.move_to_end(fp)
            self._by_graph[gfp] = fp
            while len(self._cache) > self.cache_entries:
                self._cache.popitem(last=False)
                self.telemetry["result_cache"]["evictions"] += 1
                safe_emit(self.tracker.count, "service.cache.eviction")

    def _nearby_cached(self, gfp: bytes) -> SharedMapResult | None:
        """Freshest cached result for the same (graph, hierarchy) under ANY
        config — step 1 of the degradation ladder."""
        with self._lock:
            fp = self._by_graph.get(gfp)
            if fp is None:
                return None
            res = self._cache.get(fp)
            if res is None:  # the entry was evicted; drop the dangling index
                self._by_graph.pop(gfp, None)
            return res

    def _result_copy(self, res: SharedMapResult, cache_hit: bool,
                     degradation: dict | None = None) -> SharedMapResult:
        """Fresh result per caller: private pe_of, stats annotated with the
        service telemetry (the compute stats themselves are shared refs on
        cache hits — treat them as read-only)."""
        with self._lock:
            rc = dict(self.telemetry["result_cache"])
        rc["hit"] = cache_hit
        stats = dict(res.stats)
        stats["result_cache"] = rc
        stats["service"] = {"merge_across_requests": self.merge_across_requests,
                            "pad_batch_pow2": self.pad_batch_pow2}
        stats["degradation"] = degradation or {"level": DEGRADE_FULL,
                                               "mode": "full", "reason": ""}
        return SharedMapResult(pe_of=res.pe_of.copy(), J=res.J, stats=stats)
