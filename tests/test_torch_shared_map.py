"""The slice end to end: ``repro_torch.core.api.shared_map`` with the default
config against ``repro.core.api.shared_map`` on the CPU. Same ``pe_of`` bit
for bit, J within rtol 1e-6, on unit-weight grid and rgg instances."""
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map as jax_shared_map
from repro.core.hierarchy import Hierarchy as JH
from repro.core.hierarchy import adaptive_epsilon as jax_adaptive_epsilon
from repro.core.hierarchy import mapping_cost as jax_mapping_cost
from repro.core.mapping import evaluate_J as jax_evaluate_J
from repro_torch.core import graph as TG
from repro_torch.core import multisection as TM
from repro_torch.core.api import SharedMapConfig, shared_map
from repro_torch.core.hierarchy import (Hierarchy, adaptive_epsilon, mapping_cost,
                                       parse_hierarchy)
from repro_torch.core.mapping import evaluate_J

HIERARCHIES = [(4, 2), (2, 2, 2)]
D = (1.0, 10.0, 100.0)
INSTANCES = {"grid32": lambda: JG.gen_grid(32), "rgg2000": lambda: JG.gen_rgg(2000, seed=3)}


def to_torch(jg) -> TG.Graph:
    return TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in TG.Graph._fields},
                               device="cpu")


@pytest.fixture(scope="module")
def results():
    """One JAX and one port run per (instance, hierarchy), shared by the
    tests below: JAX compiles each bucket shape once."""
    out = {}
    for name, make in INSTANCES.items():
        jg = make()
        tg = to_torch(jg)
        for a in HIERARCHIES:
            d = D[: len(a)]
            jr = jax_shared_map(jg, JH(a, d), JConfig())
            TM.reset_transfer_stats()
            tr = shared_map(tg, Hierarchy(a, d), SharedMapConfig(), device="cpu")
            out[name, a] = (jg, tg, jr, tr, TM.transfer_stats())
    return out


@pytest.mark.parametrize("a", HIERARCHIES)
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_shared_map_pe_of_bitwise(results, name, a):
    _, _, jr, tr, _ = results[name, a]
    assert tr.pe_of.dtype == np.int32
    assert np.array_equal(tr.pe_of, jr.pe_of)
    assert tr.J == pytest.approx(jr.J, rel=1e-6)


@pytest.mark.parametrize("a", HIERARCHIES)
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_shared_map_stats_and_transfers(results, name, a):
    _, _, jr, tr, xfer = results[name, a]
    for key in ("partition_calls", "padded_vertex_work", "real_vertex_work"):
        assert tr.stats[key] == jr.stats[key], key
    assert tr.stats["backend"] == "xla" and tr.stats["strategy"] == "bucket"
    assert len(tr.stats["levels"]) == len(a)
    assert xfer["d2h_array_fetches"] == 1      # the final pe_of only


def test_evaluate_J_matches(results):
    jg, tg, jr, _, _ = results["rgg2000", (2, 2, 2)]
    h = Hierarchy((2, 2, 2), D)
    pe = np.random.default_rng(0).integers(0, 8, int(jg.n)).astype(np.int32)
    assert evaluate_J(tg, h, pe, device="cpu") == pytest.approx(
        jax_evaluate_J(jg, JH((2, 2, 2), D), pe), rel=1e-6)
    with pytest.raises(ValueError, match="pe_of"):
        evaluate_J(tg, h, np.zeros(tg.N + 1, np.int32), device="cpu")
    emask = np.arange(jg.M) < int(jg.m)
    want = float(jax_mapping_cost(JH((2, 2, 2), D), jg.rows, jg.cols, jg.ewgt, pe, emask))
    got = float(mapping_cost(h, tg.rows, tg.cols, tg.ewgt, torch.from_numpy(pe),
                             torch.from_numpy(emask)))
    assert got == pytest.approx(want, rel=1e-6)


def test_hierarchy_helpers():
    h = parse_hierarchy("4:8:6", "1:10:100")
    assert h.k == 192 and h.strides == (4, 32, 192) and h.l == 3
    for args in [(0.03, 100.0, 50.0, 4, 2, 2), (0.03, 1e6, 2e5, 192, 32, 2),
                 (0.1, 10.0, 9.0, 8, 8, 3), (0.03, 5.0, 1.0, 4, 1, 0)]:
        assert adaptive_epsilon(*args) == jax_adaptive_epsilon(*args)


@pytest.mark.parametrize("kw,exc", [
    ({"strategy": "nope"}, ValueError),
])
def test_parts_not_in_this_slice_raise(kw, exc):
    """Every strategy, backend and option is ported now: ``refine_mapping``
    (tests/test_torch_mapping.py) and ``coarsen_telemetry``, whose cases
    moved to tests/test_torch_coarsen_segment.py as parity cases. An
    unknown strategy still raises."""
    g = TG.gen_grid(8, device="cpu")
    with pytest.raises(exc):
        shared_map(g, Hierarchy((2, 2), (1.0, 10.0)), SharedMapConfig(**kw), device="cpu")
