"""Kind ``service``: ``repro_torch.serve.mapper.MappingService`` at the
configuration's settings, fed by an open loop.

Traffic file: ``{"kind": "service", "rate": jobs per second, "burst": B,
"pool": {"size": P, "family", "log2_n": [...]}, "cost_requests": c,
"warmup": W}``. A launcher places B jobs at once (``submit_many``:
admitted in one scheduler iteration) every B / rate seconds, whatever the
service does: a steady cadence, the same arrivals for every seed, each job
timed from when it was due. Pool graph j has ``2 ** log2_n[j % len]``
vertices and is made from the seed j. The n requests due in the window are
one fixed set, pool graph ``i mod P`` with mapper seed i for i < n, and
``--seed`` draws only their order: the first c (c <= P, the set whose J
makes ``cost_J``) stay first, in an order of their own. So every seed
gives the same work, no request repeats another and the result cache never
hits. Requests past the window (a traced run's extra passes) follow the
same rule. The warm-up maps graphs ``0 .. W-1``, all at once, with mapper
seeds of their own.
"""
from __future__ import annotations

import time
from concurrent import futures

import numpy as np

from mapbench.harness.drivers import Job
from mapbench.harness.traffic import MAX_REQUESTS, WARM_SEED, Plan

REPLY_WAIT_S = 120.0   # how long a client waits for a reply past the close


def plan(traffic: dict, seed: int, seconds: float) -> Plan:
    rng = np.random.default_rng(seed)
    pool = traffic["pool"]
    P, c = int(pool["size"]), int(traffic["cost_requests"])
    if not c <= P:
        raise ValueError("a service mix needs cost_requests <= the pool's size")
    sizes = [int(x) for x in pool["log2_n"]]
    graphs = [(pool["family"], sizes[j % len(sizes)], j) for j in range(P)]
    rate, burst = float(traffic["rate"]), int(traffic["burst"])
    due = np.repeat(np.arange(max(1, int(rate * seconds / burst))) * burst / rate, burst)
    n = max(len(due), c)
    order = np.concatenate([rng.permutation(c), c + rng.permutation(n - c),
                            np.arange(n, MAX_REQUESTS)])
    reqs = np.stack([order % P, order], 1)
    warm = [(j, WARM_SEED + j) for j in range(int(traffic["warmup"]))]
    return Plan("service", graphs, reqs, warm, c, due)


class Load:
    EXTRA_S = 5.0   # a traced run's extra passes: seconds of the traffic each

    def __init__(self, drv):
        from repro_torch.serve.mapper import MappingService
        s = drv.cell.config["service"]
        self.drv = drv
        self.svc = MappingService(
            cache_entries=s["cache_entries"], batch_window_s=s["batch_window_s"],
            pad_batch_pow2=s["pad_batch_pow2"], max_inflight=s["max_inflight"],
            store_path=s["store_path"], workers=s["workers"], device=drv.device)
        self.before = self.svc.stats()

    def _submit(self, reqs, due: float):
        """Submit ``reqs`` ((index, graph, mapper seed), ...) at once, all due
        at ``due``; returns their (Job, future) pairs. A callback stamps each
        Job's ``t1`` when its reply comes."""
        d = self.drv
        futs = self.svc.submit_many([(d.tgs[g], d.h, d.cfg(s)) for _, g, s in reqs])
        out = []
        for (i, g, s), fut in zip(reqs, futs):
            job = Job(i, g, s, due, float("inf"))

            def done(f, job=job):
                job.t1 = time.perf_counter()
            fut.add_done_callback(done)
            out.append((job, fut))
        return out

    @staticmethod
    def _reply(job: Job, fut) -> Job:
        try:
            res = fut.result(timeout=REPLY_WAIT_S)
        except Exception as exc:   # raised, timed out or cancelled
            job.error = repr(exc)
            return job
        job.pe_of, job.J = res.pe_of, float(res.J)
        job.degraded = res.stats.get("degradation", {}).get("mode", "full") != "full"
        return job

    def warm(self) -> list[Job]:
        sub = self._submit([(-1, g, s) for g, s in self.drv.plan.warmup], time.perf_counter())
        return [self._reply(job, fut) for job, fut in sub]

    def window(self, seconds: float, first: int = 0, mark=None) -> dict:
        """The plan's arrivals due within ``seconds``, from request ``first``
        on; then every reply is awaited. ``mark = (s, fn)`` calls ``fn(jobs
        answered)`` ``s`` seconds in, once every job begun by then is
        answered: the first ``fn``'s argument jobs are the marked part."""
        self.before = self.svc.stats()
        sub, late = [], 0.0
        due_at = self.drv.plan.arrivals
        t0 = time.perf_counter()
        end = t0 + seconds
        k = 0
        while k < len(due_at) and t0 + float(due_at[k]) < end:
            due = t0 + float(due_at[k])
            burst = k + int(np.searchsorted(due_at[k:], due_at[k], "right"))
            if mark is not None and due >= t0 + mark[0]:
                _fire(mark, t0, sub)
                mark = None
            _pause_until(due)
            late = max(late, time.perf_counter() - due)
            sub += self._submit([(first + i, *self.drv.plan.request(first + i))
                                 for i in range(k, burst)], due)
            k = burst
        if mark is not None:
            _fire(mark, t0, sub)
        jobs = [self._reply(job, fut) for job, fut in sub]
        self.drv.sync()
        return {"jobs": jobs, "window_s": seconds, "drained_s": time.perf_counter() - t0,
                "completed": sum(j.ok and j.t1 <= end for j in jobs), "late_s": late}

    def counters(self) -> dict:
        """The service's counters since the window began: coalescing and faults."""
        after = self.svc.stats()
        return {group: {k: v - self.before.get(group, {}).get(k, 0)
                        for k, v in after[group].items() if isinstance(v, (int, float))}
                for group in ("coalesce", "faults", "result_cache")}

    def close(self) -> None:
        self.svc.close()


def _fire(mark, t0: float, sub) -> None:
    """At ``t0 + mark[0]``, and once every job of ``sub`` is answered (or
    has waited ``REPLY_WAIT_S``), call ``mark[1]`` with the jobs answered."""
    _pause_until(t0 + mark[0])
    futures.wait([fut for _, fut in sub], timeout=REPLY_WAIT_S)
    mark[1](sum(fut.done() for _, fut in sub))


def _pause_until(t: float) -> None:
    dt = t - time.perf_counter()
    if dt > 0:
        time.sleep(dt)
