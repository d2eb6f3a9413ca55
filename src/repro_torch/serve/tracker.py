"""Pluggable metrics trackers for the mapping service (the port's own copy
of the JAX package's ``serve.tracker``).

The service's in-process telemetry (``stats["result_cache"]``, coalescing
counters) dies with the process. A :class:`Tracker` is the minimal sink
abstraction that lets the same counters stream somewhere durable — a
logger, an in-memory store (tests), a JSON-lines file (one
dict per line, trivially ingestible), or several at once.

Two verbs only, both fire-and-forget and exception-safe from the caller's
point of view (a broken sink must never take down the serving path):

* ``count(name, value=1, **tags)`` — monotonic counters (admission, shed,
  retry, deadline-miss, cache hit/miss, degradation).
* ``event(name, **fields)`` — discrete structured occurrences (a request
  shed with its queue depth, a retry with its backoff).

Sinks MAY additionally expose ``gauge(name, value, **tags)`` (last-value
instruments: queue depth, cache entries) and ``snapshot()``; the service
probes for them with ``getattr`` so plain two-verb sinks keep working
(see :class:`CounterTracker`).

The service guards every emit with :func:`safe_emit`, so sinks may raise
freely (see tests). Modeled on levanter's ``Tracker``, scoped to what
the serving path needs.
"""
from __future__ import annotations

import atexit
import json
import logging
import threading
import time
import weakref
from typing import IO


class Tracker:
    """No-op base tracker; subclasses override ``count``/``event``."""

    def count(self, name: str, value: int = 1, **tags) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


#: Shared no-op instance (the default when no tracker is wired).
NULL_TRACKER = Tracker()


def safe_emit(fn, *args, **kwargs) -> None:
    """Invoke a tracker method, swallowing sink errors: observability must
    never fail the serving path (regression-tested with a raising sink)."""
    try:
        fn(*args, **kwargs)
    except Exception:
        logging.getLogger(__name__).debug("tracker sink error", exc_info=True)


class InMemoryTracker(Tracker):
    """Accumulates counters and events in memory (tests, benchmarks)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.events: list[dict] = []

    def count(self, name: str, value: int = 1, **tags) -> None:
        key = name if not tags else \
            name + "{" + ",".join(f"{k}={v}" for k, v in sorted(tags.items())) + "}"
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + value

    def event(self, name: str, **fields) -> None:
        with self._lock:
            self.events.append({"name": name, **fields})


class LogTracker(Tracker):
    """Streams counters/events through the stdlib logging machinery."""

    def __init__(self, logger: logging.Logger | None = None,
                 level: int = logging.INFO):
        self.logger = logger or logging.getLogger("repro_torch.serve")
        self.level = level

    def count(self, name: str, value: int = 1, **tags) -> None:
        self.logger.log(self.level, "count %s += %s %s", name, value, tags or "")

    def event(self, name: str, **fields) -> None:
        self.logger.log(self.level, "event %s %s", name, fields)


# JsonlTrackers alive at interpreter exit get a final flush. Registration
# order matters: this module is imported by serve/mapper.py BEFORE mapper
# registers its own atexit teardown, and atexit runs LIFO — so the
# service's teardown (which may emit final shed/deadline/fault events into
# a tracker) runs FIRST, and this flush runs after it, capturing those
# last events. A crash-killed process can still lose at most the current
# partially-buffered line, because writes are line-buffered.
_LIVE_JSONL: "weakref.WeakSet[JsonlTracker]" = weakref.WeakSet()


@atexit.register
def _flush_live_trackers() -> None:
    for t in list(_LIVE_JSONL):
        try:
            t.flush()
        except Exception:
            pass


class JsonlTracker(Tracker):
    """Appends one JSON object per emit to a file: a process-independent
    record of the service's admission/shed/retry/cache history.

    Crash-safe by construction: the file is opened LINE-BUFFERED, every
    emit is a single ``write()`` of one whole line, and a process-exit
    hook (ordered after the mapping service's own teardown — see
    ``_LIVE_JSONL``) flushes whatever the final teardown emitted. An
    abrupt kill can therefore truncate at most the very last line, and a
    truncated trailing line is trivially detectable by any JSONL reader.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        # buffering=1: line-buffered text mode — each full line written in
        # one call reaches the OS at the newline, not at interpreter exit.
        self._f: IO[str] | None = open(path, "a", buffering=1)
        _LIVE_JSONL.add(self)

    def _write(self, obj: dict) -> None:
        line = json.dumps(obj, default=str)
        with self._lock:
            if self._f is None:
                raise ValueError("JsonlTracker is closed")
            self._f.write(line + "\n")

    def count(self, name: str, value: int = 1, **tags) -> None:
        self._write({"t": time.time(), "kind": "count", "name": name,
                     "value": value, **tags})

    def event(self, name: str, **fields) -> None:
        self._write({"t": time.time(), "kind": "event", "name": name, **fields})

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None
        _LIVE_JSONL.discard(self)


def _render_key(name: str, tags: tuple) -> str:
    if not tags:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in tags) + "}"


def _prom_name(name: str) -> str:
    """Prometheus metric names allow ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return "_" + out if out[:1].isdigit() else (out or "_")


class CounterTracker(Tracker):
    """Prometheus-style aggregation sink.

    Unlike :class:`InMemoryTracker` (a test spy keeping raw event dicts),
    this keeps only the AGGREGATED state an operator scrapes: monotonic
    counters and last-value gauges, keyed by ``(name, sorted tags)``.
    ``event`` emits are folded in rather than stored: each becomes a
    ``events_total{name=...}`` counter bump plus one gauge per numeric
    field (``event.<name>.<field>``) — so an unbounded event stream costs
    bounded memory.

    ``snapshot()`` returns plain dicts (what ``MappingService.stats()``
    embeds under ``"tracker"``); ``to_textfile()`` renders the Prometheus
    text exposition format and ``write_textfile(path)`` publishes it
    atomically for the node-exporter textfile collector.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}

    @staticmethod
    def _key(name: str, tags: dict) -> tuple[str, tuple]:
        return name, tuple(sorted((k, str(v)) for k, v in tags.items()))

    def count(self, name: str, value: int = 1, **tags) -> None:
        key = self._key(name, tags)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float, **tags) -> None:
        with self._lock:
            self._gauges[self._key(name, tags)] = float(value)

    def event(self, name: str, **fields) -> None:
        numeric = {k: v for k, v in fields.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        key = self._key("events_total", {"name": name})
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + 1
            for k, v in numeric.items():
                self._gauges[(f"event.{name}.{k}", ())] = float(v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {_render_key(n, t): v
                             for (n, t), v in sorted(self._counters.items())},
                "gauges": {_render_key(n, t): v
                           for (n, t), v in sorted(self._gauges.items())},
            }

    def to_textfile(self) -> str:
        """Prometheus text exposition of the current state."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
        lines = []
        for kind, items in (("counter", counters), ("gauge", gauges)):
            seen = set()
            for (name, tags), val in items:
                pname = _prom_name(name)
                if pname not in seen:
                    seen.add(pname)
                    lines.append(f"# TYPE {pname} {kind}")
                label = ""
                if tags:
                    label = "{" + ",".join(
                        f'{_prom_name(k)}="{v}"' for k, v in tags) + "}"
                lines.append(f"{pname}{label} {val}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_textfile(self, path: str) -> None:
        """Atomic publish (tmp + rename): a scraper never reads a torn
        file."""
        import os
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_textfile())
        os.replace(tmp, path)


class CompositeTracker(Tracker):
    """Fans every emit out to several sinks (e.g. log + jsonl)."""

    def __init__(self, *trackers: Tracker):
        self.trackers = tuple(trackers)

    def count(self, name: str, value: int = 1, **tags) -> None:
        for t in self.trackers:
            safe_emit(t.count, name, value, **tags)

    def event(self, name: str, **fields) -> None:
        for t in self.trackers:
            safe_emit(t.event, name, **fields)

    def flush(self) -> None:
        for t in self.trackers:
            safe_emit(t.flush)

    def close(self) -> None:
        for t in self.trackers:
            safe_emit(t.close)
