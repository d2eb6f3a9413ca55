"""``repro_torch.core.taskgraph`` against ``repro.core.taskgraph`` on the
CPU, mirroring tests/test_taskgraph.py: the same canonical arrays, the same
validation messages, fingerprints byte-identical across the two packages,
the three builders and any edge order and direction, the ``to_graph`` CSR
bit for bit, the ``from_graph`` round trip, ``shared_map(tg)`` equal to
``shared_map(tg.to_graph())``, and a ``to_graph`` memo that never answers
for another device."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.taskgraph import TaskGraph as JTaskGraph
from repro_torch.core import graph as TG
from repro_torch.core.api import SharedMapConfig, shared_map, shared_map_direct
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.taskgraph import TaskGraph

H = Hierarchy(a=(4, 2), d=(1.0, 10.0))
CFG = SharedMapConfig(preset="fast")

RAW = {   # (n, u, v, w, vwgt): self-loops, duplicates both ways, zero weights
    "mixed": (4, [2, 1, 0, 3, 0, 2], [2, 0, 1, 1, 2, 0], [9.0, 2.0, 3.0, 4.0, 1.0, 6.0], None),
    "zero-weight": (3, [0, 1], [1, 2], [0.0, 2.0], None),
    "default-weights": (3, [0, 1], [1, 2], None, None),
    "vertex-weights": (5, [3, 0, 1], [1, 1, 2], [2.0, 1.0, 4.0], [1, 2, 3, 4, 5]),
    "float": (6, [0, 1, 2, 4, 5, 3], [1, 2, 3, 5, 0, 0], [0.1, 2.7, 1e-3, 4.25, 3.5, 7.125],
              [0.5, 1.5, 2.25, 1.0, 3.0, 0.75]),
}


def fields(tg) -> tuple:
    return (tg.n, tg.u, tg.v, tg.w, tg.vwgt)


def same_arrays(a: tuple, b: tuple) -> bool:
    return a[0] == b[0] and all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                                for x, y in zip(a[1:], b[1:]))


def to_jax(g: TG.Graph) -> JG.Graph:
    return JG.Graph(**{f: np.asarray(getattr(g, f).numpy()) for f in TG.Graph._fields})


@pytest.mark.parametrize("case", sorted(RAW))
@pytest.mark.parametrize("builder", ["from_edges", "from_coo"])
def test_canonical_arrays_and_fingerprint_equal_the_reference(builder, case):
    n, u, v, w, vwgt = RAW[case]
    tg = getattr(TaskGraph, builder)(n, u, v, w, vwgt=vwgt, meta={"source": case})
    jt = getattr(JTaskGraph, builder)(n, u, v, w, vwgt=vwgt)
    assert same_arrays(fields(tg), fields(jt))
    assert tg.fingerprint() == jt.fingerprint()
    assert repr(tg) == repr(jt).replace("source='?'", f"source={case!r}")


@pytest.mark.parametrize("kwargs,msg", [
    (dict(n=0, u=[], v=[]), "n >= 1"),
    (dict(n=2, u=[0], v=[2]), "out of range"),
    (dict(n=2, u=[0], v=[-1]), "out of range"),
    (dict(n=2, u=[0], v=[1], w=[-1.0]), "non-negative"),
    (dict(n=2, u=[0], v=[1], w=[float("nan")]), "finite"),
    (dict(n=2, u=[0, 1], v=[1]), "differ in length"),
    (dict(n=2, u=[0], v=[1], w=[1.0, 2.0]), "does not match"),
    (dict(n=2, u=[0], v=[1], vwgt=[1.0]), "does not match"),
    (dict(n=2, u=[0], v=[1], vwgt=[1.0, float("inf")]), "finite"),
    (dict(n=2, u=[[0]], v=[[1]]), "1-D"),
])
def test_builder_rejects_malformed_as_the_reference(kwargs, msg):
    with pytest.raises(ValueError, match=msg) as got:
        TaskGraph.from_edges(**kwargs)
    with pytest.raises(ValueError) as want:
        JTaskGraph.from_edges(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint_invariant_to_edge_order_and_direction(seed):
    u = np.array([0, 1, 2, 0, 3])
    v = np.array([1, 2, 3, 2, 4])
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    base = JTaskGraph.from_edges(5, u, v, w).fingerprint()
    rng = np.random.default_rng(seed)
    p = rng.permutation(u.size)
    flip = rng.random(u.size) < 0.5
    uu, vv = np.where(flip, v, u)[p], np.where(flip, u, v)[p]
    assert TaskGraph.from_edges(5, uu, vv, w[p]).fingerprint() == base
    both = TaskGraph.from_coo(5, np.concatenate([uu, vv]), np.concatenate([vv, uu]),
                              np.concatenate([w[p], w[p]]) / 2)
    assert both.fingerprint() == base   # COO halves summed back


@pytest.mark.parametrize("make", ["grid12", "rgg500", "rgg500-float"])
def test_from_graph_fingerprint_and_csr_equal_the_reference(make):
    g = {"grid12": lambda: TG.gen_grid(12, device="cpu"),
         "rgg500": lambda: TG.gen_rgg(500, seed=3, device="cpu"),
         "rgg500-float": lambda: TG.float_weights(TG.gen_rgg(500, seed=3, device="cpu"), 2),
         }[make]()
    tg, jt = TaskGraph.from_graph(g), JTaskGraph.from_graph(to_jax(g))
    assert same_arrays(fields(tg), fields(jt))
    assert tg.fingerprint() == jt.fingerprint()
    for pad in ({}, {"N": 1024, "M": 8192}):
        got, want = tg.to_graph(device="cpu", **pad), jt.to_graph(**pad)
        for f in TG.Graph._fields:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    rt = TaskGraph.from_graph(tg.to_graph(device="cpu"))   # the round trip
    assert rt.fingerprint() == tg.fingerprint() and (rt.n, rt.m) == (tg.n, tg.m)


def test_fingerprint_equal_across_processes_and_packages():
    """The port's fingerprint, computed in a fresh process that imports
    only the port, equals the reference's computed here."""
    code = ("from repro_torch.core.taskgraph import TaskGraph\n"
            "tg = TaskGraph.from_edges(5, [3, 0, 1], [1, 1, 2], [2.0, 1.0, 4.0],\n"
            "                          vwgt=[1, 2, 3, 4, 5])\n"
            "print(tg.fingerprint().hex())\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, timeout=120).stdout.strip()
    want = JTaskGraph.from_edges(5, [3, 0, 1], [1, 1, 2], [2.0, 1.0, 4.0],
                                 vwgt=[1, 2, 3, 4, 5]).fingerprint().hex()
    assert out == want


def test_to_graph_memo_never_crosses_devices():
    tg = TaskGraph.from_edges(6, [0, 1, 2, 4], [1, 2, 3, 5], [1.0, 2, 3, 4])
    g = tg.to_graph(device="cpu")
    assert int(g.n) == 6 and int(g.m) == 2 * tg.m
    assert tg.to_graph(device="cpu") is g                  # memoized per device
    meta = tg.to_graph(device="meta")                      # another device
    assert meta.device.type == "meta" and meta is not g
    assert tg.to_graph(device="cpu") is g and g.device.type == "cpu"
    padded = tg.to_graph(N=64, M=64, device="cpu")         # explicit padding: no memo
    assert padded.N == 64 and padded is not tg.to_graph(N=64, M=64, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):   # None = the card: no CPU answer
            tg.to_graph()
    assert tg.to_graph(device="cpu") is g


@pytest.mark.parametrize("strategy", ["bucket", "naive"])
def test_shared_map_taskgraph_bit_identical_to_graph(strategy):
    tg = TaskGraph.from_graph(TG.gen_rgg(400, seed=7, device="cpu"))
    cfg = SharedMapConfig(preset="fast", strategy=strategy)
    via_tg = shared_map(tg, H, cfg, device="cpu")
    via_g = shared_map(tg.to_graph(device="cpu"), H, cfg, device="cpu")
    direct = shared_map_direct(tg, H, cfg, device="cpu")
    for r in (via_g, direct):
        assert r.pe_of.dtype == via_tg.pe_of.dtype == np.int32
        assert np.array_equal(via_tg.pe_of, r.pe_of) and via_tg.J == r.J
