"""What decides ``correct``: every answer of the window, held by the plain
reference (``mapbench/reference``) to the configuration's guarantees.

Each served mapping is judged by three numbers (``reference.mapping.check``):
``bad_pe`` (not a mapping of the graph's vertices onto the k PEs), the
``imbalance`` of its heaviest PE, and ``J_gap``, the relative gap between
the J the program reports and the reference's J of the same mapping. The
cell's numbers are the worst over its answers; each has its limit in the
configuration's ``limits`` (``imbalance`` is the configuration's eps). A
request that never came back, raised, or was served degraded is failed.
"""
from __future__ import annotations

import numpy as np

from ..reference import mapping as ref

NAMES = ("bad_pe", "imbalance", "J_gap")


def judge(driver, jobs, limits: dict, j_of=None) -> tuple[dict, int]:
    """``({name: {"value", "limit"}}, failed)`` over ``jobs``. ``j_of(job,
    edges, table)`` replaces the J the program reported (the control)."""
    h = driver.h
    table = ref.distance_table(h.a, h.d)
    worst = dict.fromkeys(NAMES, 0.0)
    failed = 0
    for job in jobs:
        if not job.ok:
            failed += 1
            continue
        n, u, v = driver.edges[job.graph]
        J = job.J if j_of is None else j_of(job, (u, v), table)
        got = ref.check(n, u, v, None, None, job.pe_of, J, h.a, h.d, table)
        for k in NAMES:
            worst[k] = max(worst[k], got[k])
    return {k: {"value": worst[k], "limit": float(limits[k])} for k in NAMES}, failed


def passes(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def bf16_J(job, edges, table) -> float:
    """The control's J: the reference in the program's place, in bfloat16."""
    import torch
    u, v = edges
    return ref.cost_lower_precision(u, v, None, np.asarray(job.pe_of, np.int64), table,
                                    torch.bfloat16)
