"""The benchmark's inputs: the frozen generators and the traffic plans, and
how the harness finds each by name."""
import json

import numpy as np
import pytest

from mapbench.harness import manifest, traffic
from repro_torch.core.graph import gen_rgg

rgg = manifest.plugin("generators", "rgg")


def _pairs(u, v):
    """The sorted multiset of {u, v} pairs, self loops dropped."""
    u, v = np.asarray(u, np.int64), np.asarray(v, np.int64)
    keep = u != v
    lo, hi = np.minimum(u[keep], v[keep]), np.maximum(u[keep], v[keep])
    return np.sort(lo * (1 << 32) + hi)


def _graph_pairs(g):
    m = int(g.m)
    r, c = g.rows[:m].numpy(), g.cols[:m].numpy()
    return _pairs(r[r < c], c[r < c])


@pytest.mark.parametrize("seed", [0, 7])
def test_rgg_equals_the_programs_generator(seed):
    n, u, v = rgg.rgg(1 << 12, seed)
    assert n == 1 << 12 and np.all(u < v)
    assert np.array_equal(_pairs(u, v), _graph_pairs(gen_rgg(1 << 12, seed=seed, device="cpu")))


@pytest.mark.parametrize("log2_n", [8, 10])
def test_generators_are_fixed_by_their_seed(log2_n):
    a, b, c = (traffic.graph("rgg", log2_n, s) for s in (5, 5, 6))
    assert all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
    assert not np.array_equal(_pairs(*a[1:]), _pairs(*c[1:]))


DIRECT = {"kind": "direct", "graph": {"family": "rgg", "log2_n": 20, "seed": 0},
          "cost_maps": 4, "cycle": 4}
SERVICE = {"kind": "service", "rate": 4, "burst": 32, "warmup": 32, "cost_requests": 32,
           "pool": {"size": 64, "family": "rgg", "log2_n": [12, 13, 14, 15, 16]}}


@pytest.mark.parametrize("mix", [DIRECT, SERVICE])
def test_plans_vary_the_order_and_keep_the_cost_set(mix):
    big = 2**31 + 12345
    a, b, c = (traffic.plan(mix, s, 51.0) for s in (big, big, 3))
    assert np.array_equal(a.requests, b.requests) and a.graphs == b.graphs
    assert not np.array_equal(a.requests, c.requests)
    cost = a.cost
    assert sorted(map(tuple, a.requests[:cost].tolist())) == sorted(
        map(tuple, c.requests[:cost].tolist()))
    assert a.graphs[:cost] == c.graphs[:cost] or mix["kind"] == "direct"
    assert sorted(g[1] for g in a.graphs) == sorted(g[1] for g in c.graphs)
    warm = {s for _, s in a.warmup}
    assert not warm & set(a.requests[:, 1].tolist())


def test_service_requests_never_repeat():
    p = traffic.plan(SERVICE, 11, 51.0)
    pairs = p.requests[:5000]
    assert len({tuple(x) for x in pairs.tolist()}) == len(pairs)
    assert sorted(p.requests[:32, 1].tolist()) == list(range(32))


def test_service_window_is_one_set_of_work_for_every_seed():
    a, c = (traffic.plan(SERVICE, s, 51.0) for s in (2**31 + 5, 17))
    n = len(a.arrivals)
    assert a.graphs == c.graphs and not np.array_equal(a.requests[:n], c.requests[:n])
    assert sorted(map(tuple, a.requests[:n].tolist())) == sorted(
        map(tuple, c.requests[:n].tolist()))


def test_arrivals_come_in_bursts_at_a_steady_cadence():
    a, b = (traffic.plan(SERVICE, s, 51.0).arrivals for s in (1, 2))
    assert np.array_equal(a, b) and len(a) == 6 * 32
    assert np.array_equal(np.unique(a), np.arange(6) * 8.0)
    assert all((a == t).sum() == 32 for t in np.unique(a))


def test_every_mix_names_a_kind_and_generators_that_exist():
    for path in sorted((manifest.BENCH_DIR / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        p = traffic.plan(mix, 2**31 + 7, 51.0)
        assert p.kind == mix["kind"] and hasattr(traffic.kind(p.kind), "Load"), path
        for family, _, _ in p.graphs:
            assert callable(manifest.plugin("generators", family).make), path


def test_a_new_kind_and_generator_are_found_by_name(tmp_path, monkeypatch):
    """A mix whose kind and family are new files is planned and generated
    without an edit to the harness."""
    for folder, text in (("kinds", "from mapbench.harness.traffic import Plan\n"
                          "def plan(traffic, seed, seconds):\n"
                          "    return Plan('ring_once', [(traffic['family'], 4, seed)], "
                          "None, [], 0)\n"),
                         ("generators", "import numpy as np\n"
                          "def make(log2_n, seed, device='cpu'):\n"
                          "    n = 1 << log2_n\n"
                          "    return n, np.arange(n), (np.arange(n) + 1) % n\n")):
        (tmp_path / folder).mkdir()
        (tmp_path / folder / ("ring_once.py" if folder == "kinds" else "ring.py")).write_text(text)
    monkeypatch.setattr(manifest, "BENCH_DIR", tmp_path)
    p = traffic.plan({"kind": "ring_once", "family": "ring"}, 3, 1.0)
    assert p.kind == "ring_once" and p.graphs == [("ring", 4, 3)]
    n, u, v = traffic.graph(*p.graphs[0])
    assert n == 16 and np.array_equal(v, (u + 1) % 16)
    with pytest.raises(FileNotFoundError):
        traffic.kind("no_such_kind")
