"""The five baselines of the port (``core/baselines.py``) against the JAX
package's on the CPU: ``pe_of`` bit for bit with its dtype, ``stats
["refined"]``, and J before and after the swaps within rtol 1e-6, on grid
16x16, rgg 400 and rgg 400 with float weights (``graph.float_weights``;
the same shapes, so the JAX side compiles once) mapped onto 4:2 (k = 8, a
power of two, so ``kaffpa_map_style`` runs too)."""
import numpy as np
import pytest

from repro.core import baselines as JB
from repro.core import graph as JG
from repro.core.hierarchy import Hierarchy as JH
from repro_torch.core import baselines as TB
from repro_torch.core import graph as TG
from repro_torch.core.hierarchy import Hierarchy

A, D = (4, 2), (1.0, 10.0)
INSTANCES = {"grid16": lambda: TG.gen_grid(16, device="cpu"),
             "rgg400": lambda: TG.gen_rgg(400, seed=7, device="cpu"),
             "rgg400-float": lambda: TG.float_weights(TG.gen_rgg(400, seed=7, device="cpu"),
                                                      seed=7)}
TWO_PHASE_INSTANCES = ["rgg400", "rgg400-float"]
TWO_PHASE = ["global_multisection", "kaffpa_map_style"]
FLOORS = ["identity_mapping", "random_mapping", "greedy_baseline"]


def to_jax(g: TG.Graph) -> JG.Graph:
    return JG.Graph(**{f: np.asarray(getattr(g, f).numpy()) for f in TG.Graph._fields})


@pytest.fixture(scope="module")
def two_phase():
    """One JAX and one port run of each two-phase baseline per instance."""
    out = {}
    for name in TWO_PHASE_INSTANCES:
        g = INSTANCES[name]()
        for fn in TWO_PHASE:
            kw = dict(preset="fast", seed=1)
            out[name, fn] = (getattr(JB, fn)(to_jax(g), JH(A, D), **kw),
                             getattr(TB, fn)(g, Hierarchy(A, D), device="cpu", **kw))
    return out


@pytest.mark.parametrize("fn", TWO_PHASE)
@pytest.mark.parametrize("name", TWO_PHASE_INSTANCES)
def test_two_phase_baselines_bitwise(two_phase, name, fn):
    jr, tr = two_phase[name, fn]
    assert tr.pe_of.dtype == jr.pe_of.dtype == np.int64
    assert np.array_equal(tr.pe_of, jr.pe_of)
    assert tr.stats["refined"] is jr.stats["refined"] is True
    for key in ("J_before_refine", "J_after_refine"):
        assert (key in tr.stats) == (key in jr.stats), key
        if key in jr.stats:
            assert tr.stats[key] == pytest.approx(jr.stats[key], rel=1e-6)
    assert tr.stats["J_after_refine"] <= tr.stats.get("J_before_refine", np.inf)
    assert tr.stats["partition_calls"] == jr.stats["partition_calls"]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("fn", FLOORS)
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_floor_baselines_bitwise(name, fn, seed):
    g = INSTANCES[name]()
    want = getattr(JB, fn)(to_jax(g), JH(A, D), seed=seed)
    got = getattr(TB, fn)(g, Hierarchy(A, D), seed=seed, device="cpu")
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("a", [(3, 2), (4, 8, 6)])
def test_kaffpa_needs_power_of_two_k(a):
    g = TG.gen_grid(8, device="cpu")
    h = Hierarchy(a, (1.0, 10.0, 100.0)[: len(a)])
    with pytest.raises(ValueError, match="power-of-two"):
        TB.kaffpa_map_style(g, h, device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        JB.kaffpa_map_style(to_jax(g), JH(h.a, h.d))
