"""The traffic of a cell: a mix's parameters and ``--seed`` -> the graphs and
the requests, and the code that drives them.

A traffic mix (``mapbench/traffic/<mix>.json``) is data. Its ``kind`` names
the file that reads it, ``mapbench/kinds/<kind>.py``, which gives

* ``plan(traffic, seed, seconds) -> Plan``: the graphs, every request and
  its mapper seed, the warm-up and the fixed set of requests whose J makes
  ``cost_J``, all from ``--seed``;
* ``Load(driver)``: the client side of a run, with ``warm()``,
  ``window(seconds, first=0, mark=None)``, ``counters()``, ``close()`` and
  ``EXTRA_S``, the seconds of traffic each of a traced run's extra passes
  drives (0: one request).

A graph is ``(family, log2_n, seed)``; its family names its generator,
``mapbench/generators/<family>.py``. So a mix with other sizes, rates or
graphs is a new data file, a new client loop a new kind, a new graph family a
new generator, and none of them edits a file that is there. Every kind gives
each seed the same sizes and arrivals, the requests in another order, and
one fixed set of requests for ``cost_J``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import manifest

MAX_REQUESTS = 1 << 16          # more than any window holds
WARM_SEED = 1 << 19             # warm-up mapper seeds: WARM_SEED + j


@dataclasses.dataclass
class Plan:
    kind: str
    graphs: list[tuple[str, int, int]]   # (family, log2_n, generator seed)
    requests: np.ndarray                  # [MAX_REQUESTS, 2]: graph index, mapper seed
    warmup: list[tuple[int, int]]         # (graph index, mapper seed)
    cost: int                             # requests 0 .. cost-1 give cost_J
    arrivals: np.ndarray | None = None    # due times in the window, s, where the kind has them

    def request(self, i: int) -> tuple[int, int]:
        g, s = self.requests[i]
        return int(g), int(s)


def kind(name: str):
    """The module ``mapbench/kinds/<name>.py``."""
    return manifest.plugin("kinds", name)


def plan(traffic: dict, seed: int, seconds: float) -> Plan:
    """The plan of one run of the mix ``traffic`` under ``--seed`` with a
    window of ``seconds``."""
    return kind(traffic["kind"]).plan(traffic, int(seed), float(seconds))


def graph(family: str, log2_n: int, seed: int, device="cpu"):
    """The edge list ``(n, u, v)`` of one instance of ``family`` with
    2**log2_n vertices (``mapbench/generators/<family>.py``)."""
    return manifest.plugin("generators", family).make(int(log2_n), int(seed), device=device)
