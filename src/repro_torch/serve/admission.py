"""Admission control, deadlines, and retry policy for the mapping service.

The paper's serving premise is bursty traffic (mapping sits in the launch
critical path of jobs with up to millions of tasks); a service that
accepts unbounded work queues without limit. This module is the policy
layer (the port's own copy of the JAX package's ``serve.admission``):

* :class:`AdmissionController` — bounded waiting queue + bounded in-flight
  set. Over the queue bound the service LOAD-SHEDS with an explicit
  :class:`ServiceOverloadError` instead of queueing silently; a
  higher-priority arrival may instead preempt the lowest-priority waiter
  (the victim is shed). A soft watermark (``degrade_at``) marks the
  "degrade instead of full quality" region below the hard bound — the
  serving-side analogue of the fast/eco/strong quality spectrum
  (arXiv 2001.07134).
* Deadline bookkeeping — requests carry an absolute monotonic deadline;
  expiry is checked at submit, at queue admission, and cooperatively
  between multisection levels (``LevelPlanner`` checkpoints), raising
  :class:`DeadlineExceededError`.
* :class:`RetryPolicy` — bounded retries with exponential backoff for
  *transient* dispatch failures (injected faults flagged transient,
  OOM/resource-exhausted style errors); deterministic errors are never
  retried, they isolate to the offending request.

The controller is passive bookkeeping: the service mutates it under its
own scheduler lock, so there is no second lock order to reason about.
"""
from __future__ import annotations

import dataclasses
import time

import torch


class ServiceOverloadError(RuntimeError):
    """Request shed by admission control (queue full / preempted).

    Carries the observed load so callers can implement client-side
    backoff; ``retry_after_s`` is a coarse hint, not a promise.
    """

    def __init__(self, message: str, queued: int = 0, inflight: int = 0,
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.queued = queued
        self.inflight = inflight
        self.retry_after_s = retry_after_s


class DeadlineExceededError(TimeoutError):
    """Request cancelled past its deadline (queued or mid-pipeline)."""


class ServiceClosedError(RuntimeError):
    """Request rejected or abandoned because the service is shut down."""


# admission decisions (returned by AdmissionController.decide)
ADMIT = "admit"              # queue normally, full quality
ADMIT_DEGRADED = "degraded"  # queue, but serve along the quality ladder
PREEMPT = "preempt"          # queue full: shed the lowest-priority waiter
SHED = "shed"                # reject the newcomer


@dataclasses.dataclass
class AdmissionController:
    """Bounded-queue/bounded-inflight bookkeeping with priorities.

    ``max_queue`` bounds accepted-but-waiting requests, ``max_inflight``
    bounds how many the scheduler actively plans at once (backpressure:
    excess stays queued, overflow is shed). ``degrade_at`` is the soft
    watermark as a fraction of ``max_queue``: at or above it, new arrivals
    are admitted degraded (when the service enables degradation) so the
    service trades quality for survival before it starts shedding.
    """

    max_inflight: int = 16
    max_queue: int = 256
    degrade_at: float = 0.75

    def __post_init__(self):
        self.queued = 0
        self.inflight = 0
        self.counters = {"admitted": 0, "shed": 0, "preempted": 0,
                         "degraded": 0, "deadline_miss": 0}

    # -- decisions ---------------------------------------------------------

    def decide(self, priority: int, min_waiting_priority: int | None,
               degrade_ok: bool) -> str:
        """Admission decision for a newcomer with ``priority``.

        ``min_waiting_priority`` is the lowest priority currently waiting
        (None = nobody waits); a strictly higher-priority newcomer evicts
        that waiter when the queue is full.
        """
        if self.queued < self.hard_bound():
            if degrade_ok and self.queued >= self.soft_bound():
                return ADMIT_DEGRADED
            return ADMIT
        if min_waiting_priority is not None and priority > min_waiting_priority:
            return PREEMPT
        return SHED

    def hard_bound(self) -> int:
        return max(int(self.max_queue), 0)

    def soft_bound(self) -> int:
        """Queue depth at which degradation starts (clamped inside bounds)."""
        return max(min(int(self.degrade_at * self.max_queue),
                       self.hard_bound() - 1), 0)

    def overloaded(self) -> bool:
        return self.queued >= self.soft_bound() and self.queued > 0 \
            or self.hard_bound() == 0

    # -- state transitions (call under the service scheduler lock) ---------

    def note_queued(self) -> None:
        self.queued += 1
        self.counters["admitted"] += 1

    def note_degraded(self) -> None:
        """A request served along the quality ladder (queued or inline)."""
        self.counters["degraded"] += 1

    def note_dequeued(self) -> None:
        self.queued -= 1

    def note_start(self) -> None:
        self.inflight += 1

    def note_done(self) -> None:
        self.inflight -= 1

    def note_shed(self, preempted: bool = False) -> None:
        self.counters["preempted" if preempted else "shed"] += 1

    def note_deadline_miss(self) -> None:
        self.counters["deadline_miss"] += 1

    def has_capacity(self) -> bool:
        """Room for another active planner (the scheduler's gate)."""
        return self.inflight < max(int(self.max_inflight), 1)

    def snapshot(self) -> dict:
        return {"queued": self.queued, "inflight": self.inflight,
                **self.counters}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for transient failures."""

    max_retries: int = 2
    backoff_base_s: float = 0.02
    backoff_factor: float = 2.0

    def backoff_s(self, attempt: int, deadline: float | None = None) -> float:
        """Sleep before retry ``attempt`` (0-based).

        ``deadline`` (absolute ``time.monotonic()``) caps the sleep at the
        request's remaining budget: an exponential backoff must never be
        the thing that pushes a request past its deadline — the caller
        re-checks the deadline after the (possibly zero-length) sleep and
        fails with ``DeadlineExceededError`` instead of retrying late.
        """
        backoff = self.backoff_base_s * (self.backoff_factor ** attempt)
        if deadline is not None:
            backoff = min(backoff, max(deadline - time.monotonic(), 0.0))
        return backoff

    def is_transient(self, exc: BaseException) -> bool:
        """Retry-worthy? Exceptions that know (``InjectedFault``, the
        supervisor's ``WorkerCrashError``) carry a ``transient`` attribute
        and say so themselves; real-world compile/OOM-style errors are
        matched by message (runtimes surface RESOURCE_EXHAUSTED or an
        out-of-memory condition through generic RuntimeErrors). The card's
        ``torch.cuda.OutOfMemoryError`` is transient whatever its message.
        A failed kernel launch or an illegal address is not: it leaves the
        process's CUDA context unusable, so retrying in the same process
        cannot help (worker mode is the containment for it)."""
        transient = getattr(exc, "transient", None)
        if transient is not None:
            return bool(transient)
        if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
            return True
        msg = str(exc).upper()
        return any(tag in msg for tag in
                   ("RESOURCE_EXHAUSTED", "OUT OF MEMORY", "OOM",
                    "DEADLINE_EXCEEDED_BY_BACKEND", "UNAVAILABLE"))
