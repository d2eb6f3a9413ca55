"""The mapping phase of the port against the JAX package on the CPU:
``Hierarchy.digits``/``distance_table``, ``quotient_matrix``,
``greedy_mapping``, ``swap_refine`` and ``map_cost_dense`` bit for bit on
seeded partitions of the instances of tests/test_mapping.py (and a
float-weighted graph), and ``shared_map(..., refine_mapping=True)``'s
``pe_of`` bit for bit, dtype included."""
import numpy as np
import pytest

from repro.core import graph as JG
from repro.core import mapping as JM
from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map as jax_shared_map
from repro.core.hierarchy import Hierarchy as JH
from repro_torch.core import graph as TG
from repro_torch.core import mapping as TM
from repro_torch.core.api import SharedMapConfig, shared_map
from repro_torch.core.hierarchy import Hierarchy

HIERARCHIES = [((4, 8, 6), (1.0, 10.0, 100.0)), ((3, 2), (1.0, 10.0)),
               ((2, 2, 2), (1.0, 5.0, 25.0)), ((16, 16, 2), (1.0, 10.0, 100.0))]
INSTANCES = {
    "grid10": lambda: TG.gen_grid(10, device="cpu"),
    "rgg400": lambda: TG.gen_rgg(400, seed=9, device="cpu"),
    "rgg400-float": lambda: TG.float_weights(TG.gen_rgg(400, seed=9, device="cpu"), seed=7),
}


def to_jax(g: TG.Graph) -> JG.Graph:
    return JG.Graph(**{f: np.asarray(getattr(g, f).numpy()) for f in TG.Graph._fields})


def bitwise(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("a,d", HIERARCHIES)
def test_digits_and_distance_table_bitwise(a, d):
    th, jh = Hierarchy(a, d), JH(a, d)
    pes = np.random.default_rng(0).integers(0, th.k, (5, 7))
    assert bitwise(th.digits(pes), jh.digits(pes))
    assert bitwise(th.digits(np.arange(th.k)), jh.digits(np.arange(th.k)))
    assert bitwise(th.distance_table(), jh.distance_table())


@pytest.mark.parametrize("a,d", HIERARCHIES[:3])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_two_phase_routines_bitwise(name, a, d):
    """quotient_matrix of a seeded random partition and of contiguous
    blocks, then greedy construction, swaps and the dense cost."""
    tg = INSTANCES[name]()
    jg = to_jax(tg)
    th, jh = Hierarchy(a, d), JH(a, d)
    n = int(tg.n)
    for part in (np.random.default_rng(1).integers(0, th.k, n).astype(np.int32),
                 (np.arange(n, dtype=np.int64) * th.k) // n):
        C = TM.quotient_matrix(tg, part, th.k)
        assert bitwise(C, JM.quotient_matrix(jg, part, th.k))
        greedy = TM.greedy_mapping(C, th)
        assert bitwise(greedy, JM.greedy_mapping(C, jh))
        for start in (greedy, np.arange(th.k, dtype=np.int32)):
            for seed in (0, 5):
                got = TM.swap_refine(C, th, start, seed=seed, sample=512)
                assert bitwise(got, JM.swap_refine(C, jh, start, seed=seed, sample=512))
        D = th.distance_table()
        assert TM.map_cost_dense(C, D, greedy) == JM.map_cost_dense(C, D, greedy)


def test_quotient_matrix_reads_real_slots_only():
    """Padding slots (rows == cols == N-1, weight 0) never enter C, on a
    graph padded past its real sizes."""
    g = TG.gen_grid(6, device="cpu")
    gp = TG.pad_graph(g, 64, 256)
    part = np.random.default_rng(2).integers(0, 4, 36)
    C = TM.quotient_matrix(gp, np.concatenate([part, np.full(28, 3)]), 4)
    assert bitwise(C, JM.quotient_matrix(to_jax(g), part, 4))


@pytest.mark.parametrize("name", ["grid10", "rgg400-float"])
def test_refine_mapping_pe_of_bitwise(name):
    g = INSTANCES[name]()
    a, d = (4, 2), (1.0, 10.0)
    cfg = dict(preset="fast", refine_mapping=True, seed=3)
    jr = jax_shared_map(to_jax(g), JH(a, d), JConfig(**cfg))
    tr = shared_map(g, Hierarchy(a, d), SharedMapConfig(**cfg), device="cpu")
    assert tr.pe_of.dtype == np.int32 == jr.pe_of.dtype
    assert bitwise(tr.pe_of, jr.pe_of)
    assert tr.stats["refined"] is True
    assert tr.J == pytest.approx(jr.J, rel=1e-6)
    plain = shared_map(g, Hierarchy(a, d), SharedMapConfig(**{**cfg, "refine_mapping": False}),
                       device="cpu")
    assert "refined" not in plain.stats
    assert tr.J <= plain.J * (1 + 1e-6)   # the swaps never worsen J
