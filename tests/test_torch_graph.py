"""The port's graph code against the JAX package's, bitwise, on the CPU:
generators, ``from_edges``, ``repad_device``, ``ell_adjacency`` and the
device-resident ``split_blocks`` (padding slots included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro_torch.core import graph as TG

FIELDS = TG.Graph._fields


def to_torch(jg) -> TG.Graph:
    return TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in FIELDS},
                               device="cpu")


def assert_same(tensors, arrays):
    for t, a in zip(tensors, arrays):
        a = np.asarray(a)
        t = t.numpy()
        assert t.dtype == a.dtype and t.shape == a.shape
        assert np.array_equal(t.view(np.int32) if t.dtype == np.float32 else t,
                              a.view(np.int32) if a.dtype == np.float32 else a)


GENS = {
    "rgg": (lambda: JG.gen_rgg(700, seed=4), lambda: TG.gen_rgg(700, seed=4, device="cpu")),
    "grid": (lambda: JG.gen_grid(17), lambda: TG.gen_grid(17, device="cpu")),
    "road": (lambda: JG.gen_road(900, seed=2), lambda: TG.gen_road(900, seed=2, device="cpu")),
    "kron": (lambda: JG.gen_kron(9, seed=1), lambda: TG.gen_kron(9, seed=1, device="cpu")),
}


@pytest.mark.parametrize("name", sorted(GENS))
def test_generators_bitwise(name):
    jg, tg = GENS[name][0](), GENS[name][1]()
    assert_same(tg, jg)


def test_from_edges_with_weights_and_padding():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 50, 200)
    v = rng.integers(0, 50, 200)
    w = rng.integers(1, 9, 200).astype(np.float64)
    vw = rng.integers(1, 4, 50).astype(np.float64)
    jg = JG.from_edges(50, u, v, w, vw, N=64, M=512)
    tg = TG.from_edges(50, u, v, w, vw, N=64, M=512, device="cpu")
    assert_same(tg, jg)
    assert_same(TG.pad_graph(tg, 128, 1024), JG.pad_graph(jg, 128, 1024))


@pytest.mark.parametrize("N2,M2", [(1024, 8192), (700, 3000)])
def test_repad_device_bitwise(N2, M2):
    jg = JG.gen_rgg(700, seed=4)
    assert_same(TG.repad_device(to_torch(jg), N2, M2), JG.repad_device(jg, N2, M2))


@pytest.mark.parametrize("deg", [8, 16])
def test_ell_adjacency_bitwise(deg):
    jg = JG.pad_graph(JG.gen_kron(8, seed=3), 300, 6000)   # overflow rows + padding
    want = jax.jit(JG.ell_adjacency, static_argnums=1)(jg, deg)
    assert_same(TG.ell_adjacency(to_torch(jg), deg), want)
    assert TG.default_ell_deg(300, 6000) == JG.default_ell_deg(300, 6000)


@pytest.mark.parametrize("k", [2, 3])
def test_split_blocks_bitwise(k):
    """Every child array, padding slots included, the orig-id view and the
    child weight sums (template: tests/test_multisection.py:229)."""
    jg = JG.pad_graph(JG.gen_rgg(400, seed=21), 512, 4096)
    n = int(jg.n)
    rng = np.random.default_rng(k)
    part = np.full(jg.N, k, np.int32)
    part[:n] = rng.integers(0, k, n)
    orig = np.concatenate([np.arange(n), np.full(jg.N - n, n)]).astype(np.int32)
    want = jax.jit(JG.split_blocks, static_argnums=3)(
        jg, jnp.asarray(part), jnp.asarray(orig), k, jnp.int32(n))
    got = TG.split_blocks(to_torch(jg), torch.from_numpy(part), torch.from_numpy(orig),
                          k, torch.tensor(n, dtype=torch.int32))
    assert_same(got[0], want[0])
    assert_same(got[1:], want[1:])


def test_cut_and_block_weights():
    jg = JG.gen_grid(12)
    part = np.random.default_rng(0).integers(0, 4, jg.N).astype(np.int32)
    tg = to_torch(jg)
    assert float(TG.edge_cut(tg, torch.from_numpy(part))) == float(JG.edge_cut(jg, part))
    assert_same([TG.block_weights(tg, torch.from_numpy(part), 4)],
                [JG.block_weights(jg, jnp.asarray(part), 4)])


def test_i32_guard():
    with pytest.raises(ValueError, match="int32"):
        TG.check_i32_range(2**31, 5)
