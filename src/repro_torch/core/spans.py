"""Host spans: named intervals of the program's own host time, kept in memory.

Off by default, and then :func:`span` checks one module global and returns
the shared no-op :data:`NOOP`: no allocation, no clock read, no torch call.
So spans sit at the layer boundaries of the mapping path (the service's
queue, rounds and finalize; the planner's levels and device fetches; the
partitioner's phases), never on a per-launch path. :func:`enable` turns
recording on for the whole process:

* a span keeps its name, its start and end on ``time.perf_counter_ns()``,
  its own id, its parent's (the innermost span open on the same thread when
  it began), the thread, the request id where one exists, and keyword
  attributes;
* :func:`record` keeps a span whose ends fall in different calls or on
  different threads (a request's queue wait, a planner level); it has no
  parent and is no span's parent;
* while a ``torch.profiler`` records, a span also enters
  ``torch.profiler.record_function(name)``, so the profiler's own host
  timeline carries the program's phases.

Spans stay in a buffer of :data:`CAPACITY` that counts what it drops
(:func:`dropped`); nothing is written anywhere. :func:`drain` hands them
over, :func:`summary` sums them by name, and :func:`clock_offset_ns`
converts their ends to ``time.time_ns()``, the clock on which the profiler
stamps its host and device events.

    spans.enable()
    res = shared_map(g, h)
    print(spans.summary(spans.drain()))   # {"map": {"count", "total_ns", "self_ns"}, ...}
    spans.disable()
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 20   # spans kept between drains; later ones are dropped and counted


class Span(NamedTuple):
    name: str
    t0: int              # time.perf_counter_ns()
    t1: int
    id: int
    parent: int          # 0: none
    thread: int          # threading.get_ident()
    req: int | None      # the request's id, where one exists
    attrs: dict


class _NoSpan:
    """What :func:`span` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, req=None, **attrs) -> None:
        pass


NOOP = _NoSpan()

_ON = False
_LOCK = threading.Lock()
_BUF: list[Span] = []
_DROPPED = 0
_IDS = itertools.count(1)
_TLS = threading.local()
_OFFSET_NS = 0


def _stack() -> list[int]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _keep(s: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_BUF) < CAPACITY:
            _BUF.append(s)
        else:
            _DROPPED += 1


class _Open:
    """A span being recorded; :func:`span` returns one while the recorder is on."""

    __slots__ = ("name", "req", "attrs", "id", "parent", "t0", "_rf")

    def __init__(self, name: str, req, attrs: dict):
        self.name, self.req, self.attrs = name, req, attrs
        self.id = next(_IDS)

    def set(self, req=None, **attrs) -> None:
        """Set the request id or attributes known only inside the span."""
        if req is not None:
            self.req = req
        self.attrs.update(attrs)

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else 0
        st.append(self.id)
        self.t0 = time.perf_counter_ns()
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _stack().pop()
        _keep(Span(self.name, self.t0, t1, self.id, self.parent, threading.get_ident(),
                   self.req, self.attrs))
        return None


def span(name: str, req=None, **attrs):
    """A context manager that records ``name`` from entry to exit."""
    if not _ON:
        return NOOP
    return _Open(name, req, attrs)


def record(name: str, t0_ns: int, t1_ns: int, req=None, **attrs) -> None:
    """Record ``name`` from ``t0_ns`` to ``t1_ns`` (``time.perf_counter_ns()``),
    for a span that no ``with`` block can hold."""
    if _ON:
        _keep(Span(name, int(t0_ns), int(t1_ns), next(_IDS), 0, threading.get_ident(),
                   req, attrs))


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Start recording, into an emptied buffer, and take the clock offset."""
    global _ON, _OFFSET_NS, _DROPPED
    best = None
    for _ in range(8):   # the narrowest bracket of time_ns() by perf_counter_ns()
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    with _LOCK:
        _BUF.clear()
        _DROPPED = 0
    _OFFSET_NS = best[1]
    _ON = True


def disable() -> None:
    """Stop recording; spans still open are kept when they end."""
    global _ON
    _ON = False


def drain() -> list[Span]:
    """The spans kept so far, in the order they ended; the buffer empties."""
    global _BUF
    with _LOCK:
        out, _BUF = _BUF, []
    return out


def dropped() -> int:
    """Spans lost to a full buffer since :func:`enable`."""
    return _DROPPED


def clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` as :func:`enable` found it:
    a span's ``t0 + clock_offset_ns()`` is on the profiler's clock."""
    return _OFFSET_NS


def summary(recs=None) -> dict:
    """``{name: {"count", "total_ns", "self_ns"}}`` over ``recs`` (default: the
    buffer, left as it is). Self time is the total less what the span's
    children cover; a child runs inside its parent on the parent's thread."""
    if recs is None:
        with _LOCK:
            recs = list(_BUF)
    covered: dict[int, int] = {}
    for s in recs:
        if s.parent:
            covered[s.parent] = covered.get(s.parent, 0) + s.t1 - s.t0
    out: dict[str, dict] = {}
    for s in recs:
        e = out.setdefault(s.name, {"count": 0, "total_ns": 0, "self_ns": 0})
        d = s.t1 - s.t0
        e["count"] += 1
        e["total_ns"] += d
        e["self_ns"] += d - covered.get(s.id, 0)
    return out
