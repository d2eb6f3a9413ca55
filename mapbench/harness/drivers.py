"""Driving the program: the inputs and one run of a cell's traffic.

The program under test is ``repro_torch`` (``src/``). The driver makes the
plan's graphs from their generators, feeds each through
``TaskGraph.from_edges`` (the ingestion path users call) and lowers it onto
the device once through the memoized ``to_graph``; the traffic's kind
(``mapbench/kinds/<kind>.py``) then drives the program: its warm-up, the
timed window and the traced run's extra passes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import traffic


@dataclasses.dataclass
class Job:
    i: int                  # request index (map index for a direct cell)
    graph: int
    seed: int
    t0: float
    t1: float
    pe_of: np.ndarray | None = None
    J: float | None = None
    error: str | None = None
    degraded: bool = False
    levels: list | None = None

    @property
    def ok(self) -> bool:
        return self.error is None and not self.degraded and self.pe_of is not None


class Driver:
    """One run of a cell on ``device`` ("cuda" on the card, "cpu" in tests)."""

    def __init__(self, cell, seed: int, seconds: float, device: str = "cuda"):
        from repro_torch.core.api import SharedMapConfig
        from repro_torch.core.hierarchy import Hierarchy
        cfg = cell.config
        self.cell = cell
        self.device = torch.device(device)
        self.h = Hierarchy(a=tuple(int(x) for x in cfg["hierarchy"]["a"]),
                           d=tuple(float(x) for x in cfg["hierarchy"]["d"]))
        self.base = SharedMapConfig(eps=float(cfg["eps"]), preset=cfg["preset"],
                                    strategy=cfg["strategy"], backend=cfg["backend"])
        self.plan = traffic.plan(cell.traffic, seed, seconds)
        self.edges: list[tuple] = []
        self.tgs: list = []
        self.load = None

    def make_inputs(self) -> None:
        """The plan's graphs as edge lists and TaskGraphs on the device."""
        from repro_torch.core.taskgraph import TaskGraph
        top = int(self.cell.config["instance_scale_log2"])
        self.edges, self.tgs = [], []
        for family, log2_n, seed in self.plan.graphs:
            if log2_n > top:
                raise ValueError(f"{family} 2^{log2_n} exceeds the configuration's "
                                 f"instance scale 2^{top}")
            n, u, v = traffic.graph(family, log2_n, seed, self.device)
            tg = TaskGraph.from_edges(n, u, v, meta={"source": f"{family}{log2_n}:{seed}"})
            tg.to_graph(device=self.device)
            self.edges.append((n, u, v))
            self.tgs.append(tg)

    def cfg(self, seed: int):
        return dataclasses.replace(self.base, seed=int(seed))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # The traffic's kind drives the rest.

    def start(self) -> None:
        self.load = traffic.kind(self.plan.kind).Load(self)

    def warm(self) -> list[Job]:
        """The warm-up requests of the plan."""
        return self.load.warm()

    def window(self, seconds: float, first: int = 0, mark=None) -> dict:
        """``seconds`` of the plan's requests from index ``first`` on;
        ``mark = (s, fn)`` calls ``fn(units answered)`` once, ``s`` seconds in
        (a direct cell: at the first map boundary after it). Returns the jobs
        begun, the window's length on the host clock (``window_s``), and the
        jobs completed in it."""
        return self.load.window(seconds, first=first, mark=mark)

    def counters(self) -> dict:
        """The program's counters since the window began, where it keeps any."""
        return self.load.counters()

    @property
    def extra_s(self) -> float:
        return self.load.EXTRA_S

    def close(self) -> None:
        if self.load is not None:
            self.load.close()
            self.load = None
