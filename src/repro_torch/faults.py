"""Shared, deterministic fault injection (the port's own copy of the JAX
package's ``faults`` module: the same plan gives the same decisions).

The mapping service and the trainer check named seams (dispatch, cache,
finalize, a training step) so that overload and containment tests are
deterministic. This module serves both:

* A fault **site** is a string naming an injection seam ("dispatch",
  "cache", "finalize", "train_step", ...). Call :meth:`FaultInjector.check`
  at the seam; it raises :class:`InjectedFault` when the plan says so.
  The durability layer adds two seams with non-raise semantics at the
  consumer: ``"worker_kill"`` (serve/supervisor — a fired occurrence
  SIGKILLs the worker a task was just dispatched to, driving the
  crash-detect/restart/re-dispatch machinery deterministically) and
  ``"store_write"`` (serve/store — a fired occurrence publishes a
  deliberately TRUNCATED entry, a simulated torn write that the
  checksum-verified load must detect and quarantine).
* Two matching modes per site, usable together:

  - ``fail_at={"site": (i, j, ...)}`` — fail specific *occurrences*.
    With an explicit ``index=`` argument the indices match that value
    instead (the trainer's step-indexed mode); otherwise a per-site
    call counter is matched (the service's occurrence mode). Each
    (site, index) fires at most once, so a retry of the same seam
    succeeds — the canonical *transient* fault.
  - ``rates={"site": p}`` — fail each occurrence independently with
    probability ``p``, derived from ``(seed, site, count)`` by a hash
    counter-RNG: the fire pattern is a pure function of the plan, not of
    thread interleaving or global RNG state.

* ``transient`` marks raised faults as retry-worthy; consumers
  (serve/mapper retry policy, train restart loop) decide what that means.

Thread-safe; ``fired`` records every raised (site, index) for assertions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Mapping, Sequence


class InjectedFault(RuntimeError):
    """Raised by a FaultInjector to simulate an infrastructure failure."""

    def __init__(self, message: str, site: str = "", index: int = -1,
                 transient: bool = True):
        super().__init__(message)
        self.site = site
        self.index = index
        self.transient = transient


def _hash_uniform(seed: int, site: str, count: int) -> float:
    """Deterministic uniform [0, 1) from (seed, site, count) — a counter
    RNG, so concurrent sites cannot perturb each other's draw sequences."""
    h = hashlib.blake2b(f"{seed}|{site}|{count}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") / 2.0 ** 64


@dataclasses.dataclass
class FaultInjector:
    """Deterministic seeded fault plan over named injection sites.

    Parameters
    ----------
    seed: drives the ``rates`` draws (and nothing else).
    fail_at: site -> indices that must fail (occurrence count, or the
        explicit ``index=`` passed to :meth:`check`); each fires once.
    rates: site -> independent failure probability per occurrence.
    transient: whether raised faults advertise themselves as retryable.
    error_type: exception class to raise (must accept InjectedFault's
        signature); lets the trainer keep its ``InjectedFailure`` name.
    """

    seed: int = 0
    fail_at: Mapping[str, Sequence[int]] = dataclasses.field(default_factory=dict)
    rates: Mapping[str, float] = dataclasses.field(default_factory=dict)
    transient: bool = True
    error_type: type = InjectedFault

    def __post_init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._once: set[tuple[str, int]] = set()
        self.fired: list[tuple[str, int]] = []

    def check(self, site: str, index: int | None = None) -> None:
        """Raise at ``site`` if the plan says this occurrence fails.

        ``index`` overrides the per-site occurrence counter as the value
        matched against ``fail_at`` (e.g. the trainer passes the step).
        """
        with self._lock:
            count = self._counts.get(site, 0)
            self._counts[site] = count + 1
            idx = count if index is None else int(index)
            fire = False
            if idx in tuple(self.fail_at.get(site, ())) \
                    and (site, idx) not in self._once:
                self._once.add((site, idx))
                fire = True
            rate = float(self.rates.get(site, 0.0))
            if not fire and rate > 0.0 \
                    and _hash_uniform(self.seed, site, count) < rate:
                fire = True
            if fire:
                self.fired.append((site, idx))
        if fire:
            raise self.error_type(
                f"injected fault at {site}[{idx}]", site=site, index=idx,
                transient=self.transient)

    def count(self, site: str) -> int:
        """Occurrences checked at ``site`` so far."""
        with self._lock:
            return self._counts.get(site, 0)


#: Shared no-op plan — `check` never raises; use as the default injector.
NULL_INJECTOR = FaultInjector()
