"""SharedMap-driven device placement for the production meshes.

The logical communication graph of a sharded training step (heavy TP
collectives over `model`, DP ring over `data`, DCN over `pod`) is mapped
onto the physical chip hierarchy, and the result orders a mesh's devices
(DESIGN.md §3). On the homogeneous hierarchy this reproduces the default
row-major order up to group symmetry and strictly beats scrambled orders.

Host numpy throughout: the graph has 256 or 512 tasks and the mapping is
the dense one-to-one problem.

``make_production_mesh`` builds the production meshes as
``torch.distributed.device_mesh.DeviceMesh``es over the default process
group (``torchrun`` with 256 or 512 ranks, or the fake world of
``start_fake_world`` that the dry-run and the tests trace on):

  single-pod: (data=16, model=16) = 256 ranks
  multi-pod : (pod=2, data=16, model=16) = 512 ranks

Mesh position i (row-major) holds rank i under ``"default"`` and rank
``sharedmap_device_order()[i]`` under ``"sharedmap"``.
"""
from __future__ import annotations

import numpy as np
import torch

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


def make_production_mesh(*, multi_pod: bool = False, device_order: str = "default",
                         device_type: str | None = None):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over the default process group,
    on ``device_type`` (``None`` = ``"cuda"``). Raises unless the group
    exists with exactly that many ranks: there is no one-device fallback."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"the {'pod2' if multi_pod else 'pod1'} mesh needs a process group of world "
            f"size {need}; " + ("none is initialized" if have is None else f"it has {have}"))
    if device_order == "default":
        ranks = np.arange(need)
    elif device_order == "sharedmap":
        ranks = sharedmap_device_order(multi_pod=multi_pod)
    else:
        raise ValueError(device_order)
    return DeviceMesh(device_type or "cuda", torch.as_tensor(ranks.reshape(shape)),
                      mesh_dim_names=axes)


def start_fake_world(world_size: int, rank: int = 0) -> None:
    """Initialize the default process group as torch's fake backend: a world
    of ``world_size`` ranks in this one process, whose collectives move no
    data. It backs shape, byte and count tracing only (the dry-run, tests),
    never a value."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def stop_world() -> None:
    """Destroy the default process group, if there is one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
