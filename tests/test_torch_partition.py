"""The port's partitioner stages against the JAX package's, bitwise, on the
CPU: ``coarsen_once`` (ELL path), ``lp_refine``/``rebalance`` (xla
backend), ``initial_partition`` and ``partition`` on unit-weight grid and
rgg graphs padded to power-of-two shapes, as the bucket strategy pads them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coarsen as JC
from repro.core import graph as JG
from repro.core import initial as JI
from repro.core import partition as JP
from repro.core import refine as JR
from repro_torch.core import coarsen as TC
from repro_torch.core import graph as TG
from repro_torch.core import initial as TI
from repro_torch.core import partition as TP
from repro_torch.core import refine as TR

FIELDS = TG.Graph._fields


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def to_torch(jg) -> TG.Graph:
    return TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in FIELDS},
                               device="cpu")


def same(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    t = t.numpy()
    if t.dtype != a.dtype or t.shape != a.shape:
        return False
    return np.array_equal(t.view(np.int32) if t.dtype == np.float32 else t,
                          a.view(np.int32) if a.dtype == np.float32 else a)


@pytest.fixture(scope="module", params=["grid", "rgg"])
def graphs(request):
    g = JG.gen_grid(24) if request.param == "grid" else JG.gen_rgg(900, seed=5)
    jg = JG.pad_graph(g, _pow2(int(g.n)), _pow2(int(g.m)))
    return jg, to_torch(jg)


def _lmax(jg, k, eps=0.03):
    return np.float32((1.0 + np.float32(eps)) * np.float32(jg.vwgt.sum()) / k)


def test_coarsen_once_two_levels_bitwise(graphs):
    jg, tg = graphs
    deg = JG.default_ell_deg(jg.N, jg.M)
    jit_coarsen = jax.jit(JC.coarsen_once, static_argnames=("ell_deg", "rounds"))
    for salt in (138, 269):
        jg, jmap = jit_coarsen(jg, salt=jnp.int32(salt), ell_deg=deg)
        tg, tmap = TC.coarsen_once(tg, salt=salt, ell_deg=deg)
        assert same(tmap, jmap)
        for f in FIELDS:
            assert same(getattr(tg, f), getattr(jg, f)), f
    assert int(tg.n) < 0.8 * tg.N


@pytest.mark.parametrize("k", [2, 4])
def test_lp_refine_and_rebalance_bitwise(graphs, k):
    jg, tg = graphs
    n = int(jg.n)
    rng = np.random.default_rng(k)
    part = np.where(np.arange(jg.N) < n, rng.integers(0, k, jg.N), 0).astype(np.int32)
    part[: n // 3] = 0                     # overload block 0 so rebalance moves
    Lmax = _lmax(jg, k)
    jp = JR.lp_refine(jg, jnp.asarray(part), k, jnp.float32(Lmax), rounds=4,
                      salt=jnp.int32(1007), backend="xla")
    tp = TR.lp_refine(tg, torch.from_numpy(part), k, torch.tensor(Lmax), rounds=4,
                      salt=1007, backend="xla")
    assert same(tp, jp)
    jb = JR.rebalance(jg, jnp.asarray(part), k, jnp.float32(Lmax), rounds=8,
                      salt=jnp.int32(3), backend="xla")
    tb = TR.rebalance(tg, torch.from_numpy(part), k, torch.tensor(Lmax), rounds=8,
                      salt=3, backend="xla")
    assert same(tb, jb)
    assert not np.array_equal(np.asarray(jb), part)


@pytest.mark.parametrize("k", [3, 4])
def test_initial_partition_bitwise(graphs, k):
    jg, tg = graphs
    Lmax = _lmax(jg, k)
    want = JI.initial_partition(jg, k, jnp.float32(Lmax), salt=jnp.int32(262),
                                polish_rounds=8, backend="xla")
    got = TI.initial_partition(tg, k, torch.tensor(Lmax), salt=262, polish_rounds=8,
                               backend="xla")
    assert same(got, want)


@pytest.mark.parametrize("preset", ["fast", "eco"])
def test_partition_bitwise(graphs, preset):
    jg, tg = graphs
    k = 4
    levels = JP.num_levels(jg.N, k)
    assert levels == TP.num_levels(tg.N, k) and levels > 0
    want = JP.partition(jg, k, jnp.float32(0.03), levels, preset, 5, "xla")
    got = TP.partition(tg, k, 0.03, levels, preset, 5, "xla", device="cpu")
    assert same(got, want)
    Lmax = _lmax(jg, k)
    assert TR.is_balanced(tg, got, k, torch.tensor(Lmax)) == bool(
        JR.is_balanced(jg, want, k, jnp.float32(Lmax)))


def test_restart_batch_equals_single_runs(graphs):
    """Restarts as a leading batch dimension give each restart's own run."""
    _, tg = graphs
    k, Lmax = 3, torch.tensor(_lmax(graphs[0], 3))
    salts = [262, 8181]
    batch = TI.initial_partition(tg, k, Lmax, salt=salts, polish_rounds=4, backend="xla")
    for row, s in zip(batch, salts):
        assert torch.equal(row, TI.initial_partition(tg, k, Lmax, salt=s, polish_rounds=4,
                                                     backend="xla"))
    refined = TR.lp_refine(tg, batch, k, Lmax, rounds=3, salt=[5, 6], backend="xla")
    for row, p, s in zip(refined, batch, [5, 6]):
        assert torch.equal(row, TR.lp_refine(tg, p, k, Lmax, rounds=3, salt=s, backend="xla"))


def test_num_levels_matches():
    for n, k, d in [(10, 2, None), (5000, 4, None), (5000, 4, 3000), (10**6, 8, 12)]:
        assert TP.num_levels(n, k, max_degree=d) == JP.num_levels(n, k, max_degree=d)


def test_ell_backend_is_the_next_slice():
    """The ``ell`` backend is ported: ``auto`` resolves to it on the card,
    where the kernels are live, and to ``xla`` on the CPU."""
    assert TR.resolve_backend("auto", "cpu") == "xla"
    assert TR.resolve_backend("auto", torch.device("cuda")) == "ell"
    assert TR.resolve_backend("ell", "cpu") == "ell"
    assert TR.resolve_backend("xla", torch.device("cuda")) == "xla"
    with pytest.raises(ValueError):
        TR.resolve_backend("bogus", "cpu")
