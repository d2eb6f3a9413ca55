"""Kind ``direct``: one client calls ``repro_torch.core.api.shared_map`` in
process, in a closed loop, each map begun when the last has returned.

Traffic file: ``{"kind": "direct", "graph": {"family", "log2_n", "seed"},
"cost_maps": c, "cycle": r}``. The client maps one instance again and again.
Maps ``0 .. c-1`` use the mapper seeds ``0 .. c-1`` in an order drawn from
``--seed``; later maps cycle through ``r`` mapper seeds drawn from
``--seed`` (at least ``c``). The instance is the configuration's, as the
paper's instances are files: its seed is in the traffic file.
"""
from __future__ import annotations

import time

import numpy as np

from mapbench.harness.drivers import Job
from mapbench.harness.traffic import MAX_REQUESTS, WARM_SEED, Plan

CYCLE_SEEDS = 1 << 18           # later maps draw their mapper seeds below this


def plan(traffic: dict, seed: int, seconds: float) -> Plan:
    rng = np.random.default_rng(seed)
    gr = traffic["graph"]
    c, r = int(traffic["cost_maps"]), int(traffic["cycle"])
    cycle = c + rng.choice(CYCLE_SEEDS - c, size=r, replace=False)
    seeds = np.concatenate([rng.permutation(c), cycle[np.arange(MAX_REQUESTS - c) % r]])
    reqs = np.stack([np.zeros(MAX_REQUESTS, np.int64), seeds], 1)
    return Plan("direct", [(gr["family"], int(gr["log2_n"]), int(gr["seed"]))],
                reqs, [(0, WARM_SEED)], c)


class Load:
    EXTRA_S = 0.0   # a traced run's extra passes: one map each

    def __init__(self, drv):
        self.drv = drv

    def _map(self, i: int, graph: int, seed: int) -> Job:
        """One ``shared_map`` call (it returns host arrays: synchronous)."""
        from repro_torch.core.api import shared_map
        d = self.drv
        t0 = time.perf_counter()
        res = shared_map(d.tgs[graph], d.h, d.cfg(seed), device=d.device)
        t1 = time.perf_counter()
        return Job(i, graph, seed, t0, t1, pe_of=res.pe_of, J=float(res.J),
                   levels=[lv["seconds"] for lv in res.stats.get("levels", [])])

    def warm(self) -> list[Job]:
        return [self._map(-1, g, s) for g, s in self.drv.plan.warmup]

    def window(self, seconds: float, first: int = 0, mark=None) -> dict:
        """Maps from request ``first`` on until the first that ends
        ``seconds`` after the start; ``mark = (s, fn)`` calls ``fn(maps
        done)`` at the first map boundary ``s`` seconds in."""
        t0 = time.perf_counter()
        jobs: list[Job] = []
        while True:
            g, s = self.drv.plan.request(first + len(jobs))
            jobs.append(self._map(first + len(jobs), g, s))
            if mark is not None and jobs[-1].t1 >= t0 + mark[0]:
                mark[1](len(jobs))
                mark = None
            if jobs[-1].t1 >= t0 + seconds:
                break
        t_end = jobs[-1].t1
        return {"jobs": jobs, "window_s": t_end - t0, "drained_s": t_end - t0,
                "completed": len(jobs), "late_s": 0.0}

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        pass
