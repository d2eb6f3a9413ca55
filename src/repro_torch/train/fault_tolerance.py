"""Fault tolerance: restartable training with failure injection (the port
of ``repro/train/fault_tolerance.py``, on the port's own ``faults``).

* Node failures are routine at scale, so recovery is checkpoint-restart
  with a bounded window of lost work.
* The data pipeline is a pure function of the step (``data/pipeline.py``),
  so a restart replays the exact token stream: recovery is bitwise.
* Stragglers: ``StepWatchdog`` flags steps slower than a factor of the
  trailing median.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..faults import FaultInjector, InjectedFault


class InjectedFailure(InjectedFault):
    """Raised by FailureInjector to simulate a node loss (a subclass of the
    shared ``faults.InjectedFault``, kept as its own name because the
    restart loop and ``launch/train.py`` catch it)."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at given steps, each once: the ``fail_at``
    mode of the shared injector with the step as the explicit index."""

    fail_at_steps: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        self._inj = FaultInjector(fail_at={"train_step": self.fail_at_steps},
                                  error_type=InjectedFailure)

    def check(self, step: int):
        try:
            self._inj.check("train_step", index=step)
        except InjectedFailure:
            self.fired.add(step)
            raise


@dataclasses.dataclass
class StepWatchdog:
    """Flags straggler steps (> factor x trailing median)."""

    factor: float = 3.0
    window: int = 32
    times: list = dataclasses.field(default_factory=list)
    straggler_steps: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        slow = len(hist) >= 8 and seconds > self.factor * med
        if slow:
            self.straggler_steps.append(step)
        return slow


def run_with_restarts(
    run_fn: Callable[[int], int],
    max_restarts: int = 3,
    on_restart: Callable[[int, Exception], None] | None = None,
) -> int:
    """Drive ``run_fn(start_step) -> last_step`` through failures.

    ``run_fn`` must resume from the latest checkpoint when re-invoked with
    ``-1``; this wrapper is the single-process stand-in for a cluster
    controller."""
    restarts = 0
    start_step = 0
    while True:
        try:
            return run_fn(start_step)
        except InjectedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(restarts, e)
            time.sleep(0.01)  # "reschedule"
            start_step = -1   # sentinel: resume from latest checkpoint
