"""The plain reference: J, balance and validity on hand-worked cases."""
import numpy as np
import torch

from mapbench.reference import mapping as ref


def test_distance_table_by_hand():
    # H = 2:2, D = 1:10: PEs 0,1 share the inner group, as do 2,3.
    t = ref.distance_table((2, 2), (1, 10))
    assert t.tolist() == [[0, 1, 10, 10], [1, 0, 10, 10], [10, 10, 0, 1], [10, 10, 1, 0]]
    t3 = ref.distance_table((4, 8, 6), (1, 10, 100))
    assert t3.shape == (192, 192)
    assert (t3[0, 3], t3[0, 4], t3[0, 31], t3[0, 32], t3[5, 37]) == (1, 10, 10, 100, 100)


def test_cost_by_hand():
    # a path 0-1-2-3 and the chord 0-3, weights 1, 2, 3, 4; vertices on PEs 0, 1, 2, 2
    u, v, w = np.array([0, 1, 2, 0]), np.array([1, 2, 3, 3]), np.array([1., 2., 3., 4.])
    pe = np.array([0, 1, 2, 2])
    table = ref.distance_table((2, 2), (1, 10))
    # 1*d(0,1) + 2*d(1,2) + 3*d(2,2) + 4*d(0,2) = 1 + 20 + 0 + 40
    assert ref.cost(u, v, w, pe, table) == 61.0
    assert ref.cost(u, v, None, pe, table) == 1 + 10 + 0 + 10


def test_check_numbers():
    u, v = np.array([0, 1, 2, 0]), np.array([1, 2, 3, 3])
    pe = np.array([0, 1, 2, 3])   # costs 1 + 10 + 1 + 10
    good = ref.check(4, u, v, None, None, pe, 22.0, (2, 2), (1, 10))
    assert good == {"bad_pe": 0, "imbalance": 0.0, "J_gap": 0.0}
    off = ref.check(4, u, v, None, None, pe, 22.0 * 1.001, (2, 2), (1, 10))
    assert abs(off["J_gap"] - 0.001) < 1e-12
    heavy = ref.check(4, u, v, None, None, np.array([0, 0, 2, 3]), 21.0, (2, 2), (1, 10))
    assert heavy["imbalance"] == 1.0 and heavy["J_gap"] == 0.0
    bad = ref.check(4, u, v, None, None, np.array([0, 1, 4, 3]), 31.0, (2, 2), (1, 10))
    assert bad["bad_pe"] == 1
    short = ref.check(4, u, v, None, None, np.array([0, 1, 2]), 31.0, (2, 2), (1, 10))
    assert short["bad_pe"] == 1


def test_lower_precision_cost_is_off():
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 1000, 5000), rng.integers(0, 1000, 5000)
    pe = rng.integers(0, 192, 1000)
    table = ref.distance_table((4, 8, 6), (1, 10, 100))
    exact = ref.cost(u, v, None, pe, table)
    assert ref.cost_lower_precision(u, v, None, pe, table, torch.float64) == exact
    low = ref.cost_lower_precision(u, v, None, pe, table, torch.bfloat16)
    assert abs(low - exact) / exact > 1e-4
