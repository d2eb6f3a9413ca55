"""SharedMap-driven device placement for the production meshes.

The logical communication graph of a sharded training step (heavy TP
collectives over `model`, DP ring over `data`, DCN over `pod`) is mapped
onto the physical chip hierarchy, and the result orders a mesh's devices
(DESIGN.md §3). On the homogeneous hierarchy this reproduces the default
row-major order up to group symmetry and strictly beats scrambled orders.

Host numpy throughout: the graph has 256 or 512 tasks and the mapping is
the dense one-to-one problem. The reference's ``make_production_mesh``
builds a ``jax.sharding.Mesh`` from this order; the port's mesh waits for
its sharded front end (ROADMAP.md, Queue 1, item 10).
"""
from __future__ import annotations

import numpy as np

from ..core.hierarchy import Hierarchy, tpu_v5e_hierarchy
from ..core.mapping import greedy_mapping, map_cost_dense, swap_refine
from ..core.taskgraph import TaskGraph


def logical_comm_graph(multi_pod: bool = False,
                       w_model: float = 100.0, w_data: float = 10.0,
                       w_pod: float = 1.0) -> TaskGraph:
    """Communication graph of one train step between LOGICAL mesh positions.

    Edge weights ~ relative bytes: TP collectives (all-gather/all-reduce
    over `model`) dominate, DP gradient ring over `data` is second, pod-axis
    DCN gradient reduction is third (but rides the slowest link, the
    hierarchy's top level).
    """
    pods = 2 if multi_pod else 1
    k = pods * 16 * 16
    idx = np.arange(k).reshape(pods, 16, 16)
    us, vs, ws = [], [], []

    def add(u, v, w):
        us.append(u.ravel())
        vs.append(v.ravel())
        ws.append(np.full(u.size, w))

    # model axis: ring segments (XLA lowers all-gather/reduce-scatter to rings)
    add(idx[:, :, :-1], idx[:, :, 1:], w_model)
    add(idx[:, :, -1], idx[:, :, 0], w_model)        # ring wrap
    # data axis: gradient reduction ring
    add(idx[:, :-1, :], idx[:, 1:, :], w_data)
    add(idx[:, -1, :], idx[:, 0, :], w_data)
    # pod axis: DCN all-reduce pairs
    if pods > 1:
        add(idx[0], idx[1], w_pod)

    return TaskGraph.from_edges(
        k, np.concatenate(us), np.concatenate(vs), np.concatenate(ws),
        meta={"source": "logical_mesh", "multi_pod": multi_pod,
              "weights": {"model": w_model, "data": w_data, "pod": w_pod}})


def physical_hierarchy(multi_pod: bool = False) -> Hierarchy:
    """Chip topology as a process-mapping hierarchy (innermost first):
    16 chips/rack : 16 racks/pod : pods, D = intra-rack ICI 1, inter-rack
    ICI 10, DCN 100 (``core.hierarchy.tpu_v5e_hierarchy``)."""
    return tpu_v5e_hierarchy(multi_pod)


def sharedmap_device_order(multi_pod: bool = False, seed: int = 0) -> np.ndarray:
    """perm[logical_flat_position] = physical chip id.

    n == k makes this the one-to-one process mapping problem (OPMP/QAP), so
    it takes the mapping phase of the two-phase approach (paper §3):
    Müller-Merbach greedy construction + distance-restricted pair swaps on
    the dense logical communication matrix, seeded from the better of the
    default (hierarchy-aligned) order and the greedy one, so SharedMap can
    only improve on the default."""
    tg = logical_comm_graph(multi_pod=multi_pod)
    h = physical_hierarchy(multi_pod=multi_pod)
    k = h.k
    C = np.zeros((k, k))
    np.add.at(C, (tg.u, tg.v), tg.w.astype(np.float64))
    np.add.at(C, (tg.v, tg.u), tg.w.astype(np.float64))
    D = h.distance_table()

    candidates = [np.arange(k, dtype=np.int64), greedy_mapping(C, h)]
    best = min(candidates, key=lambda p: map_cost_dense(C, D, p))
    return swap_refine(C, h, best, seed=seed)
