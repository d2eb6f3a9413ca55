"""Supervised worker-process pool for the mapping service (the port's own
copy of the JAX package's ``serve.supervisor``; DESIGN.md §12).

The service is overload-safe inside one process, but a crashing kernel
launch, an out-of-memory kill or a plain SIGKILL still takes every
in-flight request down with it. On the card a launch fault leaves the
process's CUDA context unusable, so a process boundary is the only
containment for it. This module is the supervision layer:

* **Worker processes** — ``SupervisedWorkerPool`` spawns N workers
  (``multiprocessing`` *spawn* context: a forked child of a process that
  initialised CUDA cannot use the card, so ``fork`` is refused for a CUDA
  pool). Tasks are addressed by an importable function path
  (``"module:function"``) plus a picklable payload of numpy arrays and
  plain values (never CUDA tensors: no CUDA IPC crosses the boundary), so
  the worker side stays import-light until real work arrives. Each worker
  on the card holds its own CUDA context.
* **The kernel library is built before the first spawn** — a CUDA pool
  builds and loads ``kernels/_build`` in the parent, so the workers load
  the published library instead of each running ``nvcc``.
* **Health checks** — each worker runs a daemon heartbeat thread;
  the supervisor's monitor thread watches liveness (``Process.is_alive``)
  at a short poll interval and, when a ``hang_timeout_s`` is configured,
  kills workers that stop heartbeating mid-task (a hang is a crash that
  forgot to die).
* **Crash detection + restart** — a dead worker (any exit, including
  SIGKILL — exitcode ``-9``) is detected within one poll interval and
  respawned with CAPPED EXPONENTIAL BACKOFF (`restart_backoff_s` doubling
  per consecutive crash up to ``restart_backoff_cap_s``; a completed task
  resets the streak), so a crash-looping worker cannot hot-spin the host.
* **Re-dispatch** — the dead worker's in-flight task is put back at the
  FRONT of the queue (up to ``max_redispatch`` attempts) so its Future
  still resolves; only a task that kills ``max_redispatch + 1`` workers in
  a row fails, with a typed :class:`WorkerCrashError` that advertises
  itself ``transient`` (the service's retry/degradation ladder takes it
  from there). Zero unresolved futures is the contract, crash or not.
* **Deterministic fault injection** — the ``worker_kill`` seam of a
  ``repro_torch.faults.FaultInjector`` is checked right after each
  dispatch; a fired fault SIGKILLs the worker the task was just sent to.
  Tests drive the whole crash->detect->restart->re-dispatch machinery with
  ``fail_at={"worker_kill": (i, ...)}`` — no timing races.

:func:`mapping_task` is the worker-side entry point the service uses: it
rebuilds the (Graph, Hierarchy, config) request from plain numpy arrays on
the service's device and runs ``shared_map_direct`` — whole-request
isolation. Cross-request coalescing does not cross the process boundary; a
service with ``workers=N`` trades the merged dispatches for crash
isolation (DESIGN.md §12 discusses when each wins).
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import queue as queue_mod
import signal
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future

from ..faults import NULL_INJECTOR, FaultInjector, InjectedFault
from .tracker import NULL_TRACKER, Tracker, safe_emit


class WorkerCrashError(RuntimeError):
    """A task's worker died (possibly repeatedly) before finishing it.

    ``transient = True``: from the caller's perspective a crashed worker
    is retry-worthy infrastructure failure, not a property of the request
    (the service's RetryPolicy reads this attribute generically).
    """

    transient = True

    def __init__(self, message: str, redispatches: int = 0,
                 exitcode: int | None = None):
        super().__init__(message)
        self.redispatches = redispatches
        self.exitcode = exitcode


class WorkerPoolClosedError(RuntimeError):
    """Task abandoned because the pool shut down first."""


class WorkerTaskError(RuntimeError):
    """A worker task raised an exception that could not be pickled back;
    carries its repr + traceback text instead."""


def _resolve_fn(path: str):
    mod, _, attr = path.partition(":")
    if not attr:
        raise ValueError(f"task path {path!r} is not 'module:function'")
    return getattr(importlib.import_module(mod), attr)


def _worker_main(wid: int, inbox, outbox, hb_interval_s: float) -> None:
    """Worker process body: heartbeat thread + task loop.

    Messages in: ``(task_id, fn_path, payload)`` or ``None`` (shutdown).
    Messages out: ``("hb", wid)``, ``("ok", task_id, wid, result)``,
    ``("err", task_id, wid, pickled_exc_or_text)``.
    """
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent owns shutdown
    stop = threading.Event()

    def beat():
        while not stop.wait(hb_interval_s):
            try:
                outbox.put(("hb", wid))
            except Exception:
                return

    threading.Thread(target=beat, daemon=True, name="hb").start()
    while True:
        msg = inbox.get()
        if msg is None:
            stop.set()
            return
        task_id, fn_path, payload = msg
        try:
            result = _resolve_fn(fn_path)(payload)
            outbox.put(("ok", task_id, wid, result))
        except BaseException as exc:  # noqa: BLE001 — ship it to the parent
            try:
                shipped = pickle.dumps(exc)
            except Exception:
                shipped = f"{exc!r}\n{traceback.format_exc()}"
            outbox.put(("err", task_id, wid, shipped))


@dataclasses.dataclass(eq=False)
class _Task:
    id: int
    fn_path: str
    payload: object
    future: Future
    redispatches: int = 0
    worker: int | None = None
    dispatched_at: float = 0.0


@dataclasses.dataclass(eq=False)
class _Worker:
    wid: int
    proc: object = None
    inbox: object = None
    outbox: object = None
    task: _Task | None = None
    last_hb: float = 0.0
    consecutive_crashes: int = 0
    restart_at: float = 0.0   # monotonic time before which we must not spawn
    restarts: int = 0

    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()


class SupervisedWorkerPool:
    """N supervised worker processes behind a Future-based ``submit``.

    Parameters
    ----------
    workers: process count.
    ctx: multiprocessing start method ("spawn" default — a forked child of
        a process that initialised CUDA cannot use the card, and fork in a
        process with threads is unsafe anyway).
    device: the device the tasks run on (None: tasks that touch no
        device, such as :func:`echo_task`). A CUDA device refuses
        ``ctx="fork"`` and builds the kernel library in this process
        before the first worker spawns.
    heartbeat_s: worker heartbeat period (health signal).
    hang_timeout_s: if set, a busy worker whose heartbeats stop for this
        long is SIGKILLed (treated as a crash: restart + re-dispatch).
        None disables — mapping compute is bursty and compile times vary,
        so hang detection is opt-in.
    restart_backoff_s / restart_backoff_cap_s: capped exponential restart
        backoff per consecutive crash of the same worker slot.
    max_redispatch: how many times one task may be re-dispatched after
        killing its worker before its Future fails with WorkerCrashError.
    fault_injector: ``worker_kill`` seam — a fired occurrence SIGKILLs the
        worker the task was just dispatched to (deterministic crash tests).
    """

    def __init__(self, workers: int = 2, *, ctx: str = "spawn", device=None,
                 heartbeat_s: float = 0.2, hang_timeout_s: float | None = None,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_cap_s: float = 2.0,
                 max_redispatch: int = 2, poll_s: float = 0.02,
                 fault_injector: FaultInjector = NULL_INJECTOR,
                 tracker: Tracker = NULL_TRACKER):
        import multiprocessing as mp
        if device is not None and str(device).startswith("cuda"):
            if ctx == "fork":
                raise ValueError("a worker pool on a CUDA device cannot fork: a forked "
                                 "child of a process that initialised CUDA cannot use "
                                 "the card; use ctx='spawn'")
            from ..kernels import _build
            _build.library()   # built once here; the workers load it
        self._mp = mp.get_context(ctx)
        self.heartbeat_s = float(heartbeat_s)
        self.hang_timeout_s = hang_timeout_s
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_cap_s = float(restart_backoff_cap_s)
        self.max_redispatch = int(max_redispatch)
        self.poll_s = float(poll_s)
        self.faults = fault_injector
        self.tracker = tracker
        self._lock = threading.Lock()
        self._closed = False
        self._seq = 0
        self._pending: deque[_Task] = deque()
        self._inflight: dict[int, _Task] = {}
        self._counters = {"submitted": 0, "ok": 0, "err": 0, "crashes": 0,
                          "restarts": 0, "redispatched": 0,
                          "crash_failed": 0, "killed_injected": 0,
                          "hang_kills": 0, "outbox_errors": 0}
        self._workers = {i: _Worker(wid=i) for i in range(max(int(workers), 1))}
        for w in self._workers.values():
            self._spawn(w)
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True, name="pool-collector")
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="pool-monitor")
        self._collector.start()
        self._monitor.start()

    # ----------------------------------------------------------- frontend

    def submit(self, fn_path: str, payload) -> Future:
        """Run ``fn_path(payload)`` on some worker; Future resolves with
        the task's return value, its (re-raised) exception, or a typed
        WorkerCrashError/WorkerPoolClosedError."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise WorkerPoolClosedError("worker pool is closed")
            self._seq += 1
            task = _Task(id=self._seq, fn_path=fn_path, payload=payload,
                         future=fut)
            self._counters["submitted"] += 1
            self._pending.append(task)
            self._dispatch_locked()
        return fut

    def stats(self) -> dict:
        with self._lock:
            snap = dict(self._counters)
            snap["workers"] = len(self._workers)
            snap["alive"] = sum(1 for w in self._workers.values() if w.alive())
            snap["pending"] = len(self._pending)
            snap["inflight"] = len(self._inflight)
        return snap

    def close(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Stop the pool. ``wait=True`` drains in-flight tasks first (up
        to ``timeout``); either way every unfinished Future is failed with
        :class:`WorkerPoolClosedError` before workers are torn down."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if wait:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._inflight and not self._pending:
                        break
                time.sleep(self.poll_s)
        with self._lock:
            doomed = list(self._pending) + list(self._inflight.values())
            self._pending.clear()
            self._inflight.clear()
            workers = list(self._workers.values())
        exc = WorkerPoolClosedError("worker pool closed before the task "
                                    "completed")
        for task in doomed:
            if not task.future.done():
                task.future.set_exception(exc)
        for w in workers:
            if w.alive():
                try:
                    w.inbox.put(None)
                except Exception:
                    pass
        t0 = time.monotonic()
        for w in workers:
            if w.proc is not None:
                w.proc.join(max(0.0, 1.0 - (time.monotonic() - t0)))
                if w.proc.is_alive():
                    w.proc.kill()
                    w.proc.join(1.0)
                    w.inbox.cancel_join_thread()   # see _monitor_loop

    def __enter__(self) -> "SupervisedWorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(wait=exc[0] is None)

    # --------------------------------------------------------- scheduling

    def _spawn(self, w: _Worker) -> None:
        """(Re)start one worker slot with FRESH queues in both directions.

        Queues are strictly per-worker and single-writer: the parent is
        the only writer of the inbox, the worker the only writer of its
        outbox. A shared outbox would be a liveness hazard — an
        ``mp.Queue`` guards its pipe with a cross-process write lock, and
        a worker SIGKILLed mid-``put`` dies HOLDING it, silently wedging
        every surviving worker's sends (observed in the burst-kill test).
        With one writer per queue, a kill can only poison the dead
        worker's own queues, which are discarded here on respawn.
        """
        w.inbox = self._mp.Queue()
        w.outbox = self._mp.Queue()
        w.proc = self._mp.Process(
            target=_worker_main,
            args=(w.wid, w.inbox, w.outbox, self.heartbeat_s),
            daemon=True, name=f"mapper-worker-{w.wid}")
        w.proc.start()
        w.last_hb = time.monotonic()

    def _dispatch_locked(self) -> None:
        """Assign pending tasks to idle live workers. Caller holds _lock."""
        kills = []
        for w in self._workers.values():
            if not self._pending:
                break
            if w.task is None and w.alive():
                task = self._pending.popleft()
                task.worker = w.wid
                task.dispatched_at = time.monotonic()
                w.task = task
                self._inflight[task.id] = task
                try:
                    w.inbox.put((task.id, task.fn_path, task.payload))
                except Exception:
                    # broken pipe to a dying worker: requeue, let the
                    # monitor handle the corpse.
                    w.task = None
                    self._inflight.pop(task.id, None)
                    task.worker = None
                    self._pending.appendleft(task)
                    continue
                try:
                    self.faults.check("worker_kill")
                except InjectedFault:
                    kills.append(w)
        for w in kills:  # SIGKILL outside the per-worker bookkeeping
            self._counters["killed_injected"] += 1
            safe_emit(self.tracker.event, "worker_kill_injected", wid=w.wid)
            try:
                os.kill(w.proc.pid, signal.SIGKILL)
            except OSError:
                pass

    # ------------------------------------------------------ result intake

    def _collect_loop(self) -> None:
        """Drain every live worker's private outbox (non-blocking polls —
        never a blocking read on a queue whose writer might be killed
        mid-frame)."""
        while True:
            with self._lock:
                if self._closed:
                    return
                outboxes = [w.outbox for w in self._workers.values()
                            if w.outbox is not None]
            got_any = False
            for q in outboxes:
                while True:
                    try:
                        msg = q.get_nowait()
                    except queue_mod.Empty:
                        break
                    except Exception:
                        with self._lock:
                            self._counters["outbox_errors"] += 1
                        break
                    got_any = True
                    self._handle_msg(msg)
            if not got_any:
                time.sleep(self.poll_s)

    def _handle_msg(self, msg) -> None:
        kind = msg[0]
        if kind == "hb":
            with self._lock:
                w = self._workers.get(msg[1])
                if w is not None:
                    w.last_hb = time.monotonic()
            return
        _, task_id, wid, body = msg
        with self._lock:
            task = self._inflight.pop(task_id, None)
            w = self._workers.get(wid)
            if w is not None:
                if w.task is task and task is not None:
                    w.task = None
                w.consecutive_crashes = 0  # a finished task ends a streak
            self._counters["ok" if kind == "ok" else "err"] += 1
            self._dispatch_locked()
        if task is None:
            return  # late result for a task already re-dispatched/failed
        if kind == "ok":
            if not task.future.done():
                task.future.set_result(body)
        else:
            exc: BaseException
            if isinstance(body, (bytes, bytearray)):
                try:
                    exc = pickle.loads(body)
                except Exception:
                    exc = WorkerTaskError("worker task failed "
                                          "(unpicklable exception)")
            else:
                exc = WorkerTaskError(str(body))
            if not task.future.done():
                task.future.set_exception(exc)

    # --------------------------------------------------------- supervision

    def _monitor_loop(self) -> None:
        while True:
            time.sleep(self.poll_s)
            now = time.monotonic()
            crashed: list[tuple[_Worker, _Task | None, int | None]] = []
            exhausted: list[tuple[_Task, WorkerCrashError]] = []
            with self._lock:
                if self._closed:
                    return
                for w in self._workers.values():
                    if w.proc is None:
                        continue
                    if w.alive():
                        if (self.hang_timeout_s is not None
                                and w.task is not None
                                and now - w.last_hb > self.hang_timeout_s
                                and now - w.task.dispatched_at
                                > self.hang_timeout_s):
                            self._counters["hang_kills"] += 1
                            safe_emit(self.tracker.event, "worker_hang_kill",
                                      wid=w.wid)
                            try:
                                os.kill(w.proc.pid, signal.SIGKILL)
                            except OSError:
                                pass
                        continue
                    # dead worker slot: drain happens never again — its
                    # outbox may hold a torn frame, so it is dropped (a
                    # completed-but-unreported result is simply recomputed
                    # via re-dispatch).
                    exitcode = w.proc.exitcode
                    # The dead worker never reads its inbox again. A payload
                    # still in the pipe (one larger than the pipe's buffer,
                    # killed mid-read) blocks the queue's feeder thread for
                    # good, and the interpreter joins that thread at exit:
                    # the parent would hang on exit. Nothing in it is needed
                    # (the task is re-dispatched), so let it go unjoined.
                    w.inbox.cancel_join_thread()
                    task = w.task
                    w.task = None
                    w.proc = None
                    w.outbox = None
                    w.consecutive_crashes += 1
                    backoff = min(
                        self.restart_backoff_s
                        * (2.0 ** (w.consecutive_crashes - 1)),
                        self.restart_backoff_cap_s)
                    w.restart_at = now + backoff
                    self._counters["crashes"] += 1
                    crashed.append((w, task, exitcode))
                    if task is not None and task.id in self._inflight:
                        del self._inflight[task.id]
                        if task.redispatches < self.max_redispatch:
                            task.redispatches += 1
                            task.worker = None
                            self._counters["redispatched"] += 1
                            self._pending.appendleft(task)  # keep its turn
                        else:
                            self._counters["crash_failed"] += 1
                            exhausted.append((task, WorkerCrashError(
                                f"worker died {task.redispatches + 1} "
                                f"times running this task "
                                f"(last exitcode {exitcode})",
                                redispatches=task.redispatches,
                                exitcode=exitcode)))
                # respawn slots whose backoff has elapsed
                for w in self._workers.values():
                    if w.proc is None and now >= w.restart_at:
                        self._spawn(w)
                        w.restarts += 1
                        self._counters["restarts"] += 1
                        safe_emit(self.tracker.event, "worker_restart",
                                  wid=w.wid,
                                  consecutive_crashes=w.consecutive_crashes)
                self._dispatch_locked()
            # future resolution OUTSIDE the lock: set_exception runs done-
            # callbacks synchronously (the mapping service hooks one).
            for task, exc in exhausted:
                if not task.future.done():
                    task.future.set_exception(exc)
            for w, task, exitcode in crashed:
                safe_emit(self.tracker.event, "worker_crash", wid=w.wid,
                          exitcode=exitcode,
                          had_task=task is not None)


# ---------------------------------------------------------------------------
# the mapping service's worker-side task
# ---------------------------------------------------------------------------

def mapping_task(payload: dict) -> dict:
    """Worker entry point: rebuild the request from plain arrays on
    ``payload["device"]`` (the service's device, as a string) and run the
    direct mapping path there. Heavy imports stay inside the function so
    the supervisor module (and crash tests using cheap tasks) never pay
    them.

    ``payload["timeout_s"]`` (remaining deadline budget at dispatch time)
    becomes a worker-local monotonic deadline enforced at the multisection
    level checkpoints — monotonic clocks are not comparable across
    processes, so the parent ships a duration, not an instant.
    """
    import numpy as np

    from ..core.api import SharedMapConfig, shared_map_direct
    from ..core.graph import assemble_padded
    from ..core.hierarchy import Hierarchy
    from .admission import DeadlineExceededError

    deadline = None
    if payload.get("timeout_s") is not None:
        deadline = time.monotonic() + float(payload["timeout_s"])

    def checkpoint():
        if deadline is not None and time.monotonic() > deadline:
            raise DeadlineExceededError("deadline exceeded in worker")

    device = payload["device"]
    g = assemble_padded(np.asarray(payload["vwgt"], np.float32),
                        np.asarray(payload["rows"], np.int32),
                        np.asarray(payload["cols"], np.int32),
                        np.asarray(payload["ewgt"], np.float32),
                        int(payload["n"]), int(payload["N"]),
                        int(payload["M"]), device=device)
    h = Hierarchy(a=tuple(payload["a"]), d=tuple(payload["d"]))
    cfg = SharedMapConfig(**payload["cfg"])
    res = shared_map_direct(g, h, cfg, checkpoint=checkpoint,
                            resident=payload.get("resident"), device=device)
    return {"pe_of": np.asarray(res.pe_of), "J": float(res.J),
            "stats": res.stats}


def echo_task(payload: dict) -> dict:
    """Trivial task for pool tests/benchmarks: optional sleep, optional
    self-SIGKILL (a worker crash with no injector involved), then echo."""
    if payload.get("sleep_s"):
        time.sleep(float(payload["sleep_s"]))
    if payload.get("die"):
        os.kill(os.getpid(), signal.SIGKILL)
    if payload.get("raise"):
        raise ValueError(str(payload["raise"]))
    return payload
