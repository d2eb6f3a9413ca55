"""The ``ell`` refinement backend against the JAX package's, on the CPU.

The same numpy inputs go through the JAX functions (jitted; the Pallas
``lp_gain`` kernel in interpret mode) and their counterparts in
``repro_torch``: the ``lp_gain`` plain version, the threshold admission,
``lp_refine``/``rebalance`` on a power-law graph whose hubs overflow the
ELL cap, ``initial_partition``, ``partition`` and ``shared_map`` with
``backend="ell"``. Everything compares bit for bit on integer weights.
Two rounding findings have their own tests: the tie jitter (no fused
multiply-add can change it) and the float32 ``**`` of the adaptive
imbalance (torch's differs from XLA's; the port matches XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import hierarchy as JHM
from repro.core import initial as JI
from repro.core import partition as JP
from repro.core import refine as JR
from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map as jax_shared_map
from repro.kernels import ref as jref
from repro.kernels.lp_gain import lp_gain_pallas
from repro_torch.core import graph as TG
from repro_torch.core import hierarchy as THM
from repro_torch.core import initial as TI
from repro_torch.core import partition as TP
from repro_torch.core import refine as TR
from repro_torch.core.api import SharedMapConfig, shared_map
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lp_gain import lp_gain_cuda

T = torch.from_numpy
FIELDS = TG.Graph._fields


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def to_torch(jg) -> TG.Graph:
    return TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in FIELDS},
                               device="cpu")


def bits(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def same(t, a) -> bool:
    t, a = bits(t), bits(a)
    return t.shape == a.shape and t.dtype == a.dtype and np.array_equal(t, a)


def _lmax(jg, k, eps=0.03):
    return np.float32((1.0 + np.float32(eps)) * np.float32(jg.vwgt.sum()) / k)


# ---------------------------------------------------------------------------
# the lp_gain plain version
# ---------------------------------------------------------------------------

def _ell_inputs(n, deg, k, seed, R=1, integer=True):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n + 1, (n, deg)).astype(np.int32)          # n == pad
    adj[rng.random(n) < 0.1] = n                                       # empty rows
    w = rng.integers(1, 9, (n, deg)) if integer else rng.random((n, deg))
    adw = (w * (adj < n)).astype(np.float32)
    part = rng.integers(0, k, (R, n)).astype(np.int32)
    return adj, adw, part


@pytest.mark.parametrize("n,deg,k", [(128, 8, 4), (300, 16, 8), (1024, 32, 16), (77, 128, 3)])
def test_lp_gain_ref_bitwise(n, deg, k):
    """All three outputs equal the JAX oracle's and the Pallas kernel's
    (interpret mode) bit for bit on integer weights."""
    adj, adw, part = _ell_inputs(n, deg, k, seed=n * k)
    got = ref.lp_gain_ref(T(adj), T(adw), T(part[0]), k)
    want_ref = jax.jit(jref.lp_gain_ref, static_argnums=3)(adj, adw, part[0], k)
    want_pallas = lp_gain_pallas(jnp.asarray(adj), jnp.asarray(adw), jnp.asarray(part[0]),
                                 k, interpret=True)
    for a, b, c in zip(got, want_ref, want_pallas):
        assert same(a, b) and same(a, c)


def test_lp_gain_ref_restart_batch():
    """[R, N] labels give each row's own [N] result, and the route sends CPU
    tensors to the plain version."""
    adj, adw, part = _ell_inputs(500, 24, 6, seed=7, R=3)
    conn, best, gain = ops.lp_gain(T(adj), T(adw), T(part), 6)
    assert conn.shape == (3, 500, 6) and best.dtype == torch.int32
    for r in range(3):
        for a, b in zip((conn[r], best[r], gain[r]),
                        jax.jit(jref.lp_gain_ref, static_argnums=3)(adj, adw, part[r], 6)):
            assert same(a, b)


def test_lp_gain_ref_float_weights_rtol():
    """Float weights: the plain version sums in slot order, the JAX oracle in
    its own order, so conn and gain agree within rtol 1e-6."""
    adj, adw, part = _ell_inputs(700, 32, 5, seed=3, integer=False)
    got = ref.lp_gain_ref(T(adj), T(adw), T(part[0]), 5)
    want = jax.jit(jref.lp_gain_ref, static_argnums=3)(adj, adw, part[0], 5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-5)


def test_csr_to_ell_bitwise():
    rng = np.random.default_rng(11)
    N, M, DEG = 300, 2500, 8          # mean degree 8: many rows are truncated
    rows = rng.integers(0, N + 3, M).astype(np.int32)   # a few rows out of range
    cols = rng.integers(0, N, M).astype(np.int32)
    ewgt = rng.integers(1, 5, M).astype(np.float32)
    want = jax.jit(jref.csr_to_ell, static_argnums=(3, 4))(rows, cols, ewgt, N, DEG)
    got = ref.csr_to_ell(T(rows), T(cols), T(ewgt), N, DEG)
    for a, b in zip(got, want):
        assert same(a, b)


def test_lp_gain_cuda_refuses_cpu_tensors_and_bad_shapes():
    adj, adw, part = _ell_inputs(64, 8, 4, seed=1)
    with pytest.raises(ValueError):
        lp_gain_cuda(T(adj), T(adw), T(part), 4)


# ---------------------------------------------------------------------------
# rounding findings
# ---------------------------------------------------------------------------

def test_tie_jitter_rounding():
    """``gbest * (1 + 1e-3 * tiebreak)``: for every one of the 65536
    tiebreak values, one rounding of ``1 + 1e-3 * t`` (a fused multiply-add)
    and two roundings give the same float32, so XLA's fusing or not cannot
    change it; the port's expression equals jitted JAX's everywhere."""
    tb = np.arange(1 << 16, dtype=np.uint32).astype(np.float32) / np.float32(1 << 16)
    rng = np.random.default_rng(5)
    gbest = (rng.integers(1, 5000, tb.shape[0])
             * np.where(rng.random(tb.shape[0]) < 0.5, 1.0, 0.37)).astype(np.float32)
    want = np.asarray(jax.jit(lambda g, t: g * (1.0 + JR._TIE_JITTER * t))(gbest, tb))
    got = (T(gbest) * (1.0 + TR._TIE_JITTER * T(tb))).numpy()
    assert same(got, want)
    jj = torch.tensor(TR._TIE_JITTER, dtype=torch.float32).expand(tb.shape[0])
    fused = ref.fma_f32(jj, T(tb), torch.ones(tb.shape[0]))
    assert same(fused, (1.0 + TR._TIE_JITTER * T(tb)))


def test_adaptive_epsilon_pow_rounding():
    """XLA computes ``x ** float32(1/d)`` as ``x`` (d = 1), ``sqrt`` (d = 2)
    or the C library's ``powf``; torch's float32 ``pow`` rounds otherwise in
    a few percent of cases. The port's ``_powf`` matches XLA everywhere."""
    rng = np.random.default_rng(2)
    x = (rng.random(20000) * 4 + 0.25).astype(np.float32)
    for depth in (1, 2, 3, 4, 5):
        e = np.float32(1.0 / depth)
        want = np.asarray(jax.jit(lambda a: a ** jnp.float32(1.0 / depth))(x))
        assert same(THM._powf(T(x), depth), want), depth
        if depth >= 2:
            assert (bits(T(x) ** float(e)) != bits(want)).sum() > 0, depth


@pytest.mark.parametrize("a", [(4, 8, 6), (2, 2, 2), (3, 2, 2), (4, 2, 3), (16, 16, 2)])
def test_adaptive_epsilon_tensor_bitwise(a):
    """The device strategy's eps at every depth of real hierarchies, on
    integer subgraph weights near each level's share of the total."""
    rng = np.random.default_rng(sum(a))
    k = int(np.prod(a))
    for total in (2000, 4096, 1 << 20):
        for depth in range(len(a), 0, -1):
            k_sub = int(np.prod(a[:depth]))
            share = total * k_sub / k
            ws = np.maximum(np.round(share * (1 + 0.05 * rng.standard_normal(64))), 1
                            ).astype(np.float32)
            tw = np.float32(total)
            want = jax.jit(JHM.adaptive_epsilon_jnp, static_argnums=(0, 3, 4, 5))(
                0.03, tw, ws, k, k_sub, depth)
            got = THM.adaptive_epsilon_tensor(0.03, torch.tensor(tw), T(ws), k, k_sub, depth)
            assert same(got, want), (total, depth)


# ---------------------------------------------------------------------------
# admission, refinement and rebalancing on a graph with overflow rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kron():
    """gen_kron(10): hubs far above the ELL cap of its mean degree."""
    g = JG.gen_kron(10, seed=1)
    jg = JG.pad_graph(g, _pow2(int(g.n)), _pow2(int(g.m)))
    n, m = int(jg.n), int(jg.m)
    deg = JG.default_ell_deg(1, (m + n - 1) // n)
    return jg, to_torch(jg), deg


def test_kron_has_overflow_rows(kron):
    jg, tg, deg = kron
    overflow = TG.ell_adjacency(tg, deg)[2]
    assert int(overflow.sum()) >= 20
    assert same(overflow, JG.ell_adjacency(jg, deg)[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_admit_by_threshold_bitwise(seed):
    """Integer gains with many ties (the jitter splits them), per restart
    row against the reference's single-lane function."""
    rng = np.random.default_rng(seed)
    R, N, k = 2, 3000, 6
    cand = rng.random((R, N)) < 0.6
    best = rng.integers(0, k, (R, N)).astype(np.int32)
    gbest = np.where(cand, rng.integers(1, 6, (R, N)), -1e30).astype(np.float32)
    vw = rng.integers(1, 4, N).astype(np.float32)
    cap = rng.integers(-5, 900, (R, k)).astype(np.float32)
    tiebreak = (rng.integers(0, 1 << 16, (R, N)) / float(1 << 16)).astype(np.float32)
    got = TR._admit_by_threshold(T(cand), T(best), T(gbest), T(vw), T(cap), k, T(tiebreak))
    fn = jax.jit(JR._admit_by_threshold, static_argnums=5)
    for r in range(R):
        want = fn(cand[r], best[r], gbest[r], vw, cap[r], k, tiebreak[r])
        assert same(got[r], want)
    assert 0 < int(got.sum()) < int(cand.sum())


@pytest.mark.parametrize("k", [2, 5])
def test_lp_refine_and_rebalance_ell_bitwise(kron, k):
    """Both degree-cap policies: lp_refine freezes the overflow rows,
    rebalance moves them on truncated connectivity."""
    jg, tg, deg = kron
    n = int(jg.n)
    rng = np.random.default_rng(k)
    part = np.where(np.arange(jg.N) < n, rng.integers(0, k, jg.N), 0).astype(np.int32)
    part[: n // 3] = 0                     # overload block 0 so rebalance moves
    Lmax = _lmax(jg, k)
    jp = JR.lp_refine(jg, jnp.asarray(part), k, jnp.float32(Lmax), rounds=4,
                      salt=jnp.int32(1007), backend="ell", ell_deg=deg)
    tp = TR.lp_refine(tg, T(part), k, torch.tensor(Lmax), rounds=4, salt=1007,
                      backend="ell", ell_deg=deg)
    assert same(tp, jp)
    overflow = TG.ell_adjacency(tg, deg)[2].numpy()
    assert np.array_equal(tp.numpy()[overflow], part[overflow])   # frozen
    assert not np.array_equal(tp.numpy(), part)
    jb = JR.rebalance(jg, jnp.asarray(part), k, jnp.float32(Lmax), rounds=8,
                      salt=jnp.int32(3), backend="ell", ell_deg=deg)
    tb = TR.rebalance(tg, T(part), k, torch.tensor(Lmax), rounds=8, salt=3,
                      backend="ell", ell_deg=deg)
    assert same(tb, jb)
    assert not np.array_equal(tb.numpy(), part)


def test_degree_cap_policies():
    """A star whose hub (degree 40) overflows the cap 8 and whose first 8
    neighbours sit in the other block: lp_refine freezes the hub under
    "ell" (it moves under "xla", which sees all its edges), rebalance
    drains it first on its truncated connectivity. Bitwise against JAX."""
    n = 64
    u, v = np.zeros(40, np.int64), np.arange(1, 41)
    part = np.zeros(n, np.int32)
    part[1:31] = 1                         # leaves 1..30 in block 1
    k, Lmax, deg = 2, np.float32(33.0), 8
    jg = JG.from_edges(n, u, v)
    tg = TG.from_edges(n, u, v, device="cpu")
    assert bool(TG.ell_adjacency(tg, deg)[2][0])
    out = {}
    for name, fn, kw in (("refine_ell", "lp_refine", {"backend": "ell", "ell_deg": deg}),
                         ("refine_xla", "lp_refine", {"backend": "xla"}),
                         ("rebalance_ell", "rebalance", {"backend": "ell", "ell_deg": deg})):
        want = getattr(JR, fn)(jg, jnp.asarray(part), k, jnp.float32(Lmax), rounds=4,
                               salt=jnp.int32(1), **kw)
        got = getattr(TR, fn)(tg, T(part), k, torch.tensor(Lmax), rounds=4, salt=1, **kw)
        assert same(got, want), name
        out[name] = got.numpy()
    assert out["refine_ell"][0] == 0       # frozen
    assert out["refine_xla"][0] == 1       # full connectivity: moves
    assert out["rebalance_ell"][0] == 1    # movable on truncated conn


def test_lp_refine_ell_restart_batch(kron):
    """[R, N] restarts with one salt each equal the single runs."""
    _, tg, deg = kron
    k, Lmax = 4, torch.tensor(_lmax(kron[0], 4))
    rng = np.random.default_rng(9)
    parts = T(rng.integers(0, k, (2, tg.N)).astype(np.int32))
    parts = torch.where(TG.vertex_mask(tg), parts, 0)
    batch = TR.lp_refine(tg, parts, k, Lmax, rounds=3, salt=[5, 6], backend="ell",
                         ell_deg=deg)
    for row, p, s in zip(batch, parts, [5, 6]):
        assert torch.equal(row, TR.lp_refine(tg, p, k, Lmax, rounds=3, salt=s,
                                             backend="ell", ell_deg=deg))


def test_initial_partition_ell_bitwise(kron):
    jg, tg, deg = kron
    k = 3
    Lmax = _lmax(jg, k)
    want = JI.initial_partition(jg, k, jnp.float32(Lmax), salt=jnp.int32(262),
                                polish_rounds=8, backend="ell", ell_deg=deg)
    got = TI.initial_partition(tg, k, torch.tensor(Lmax), salt=262, polish_rounds=8,
                               backend="ell", ell_deg=deg)
    assert same(got, want)


# ---------------------------------------------------------------------------
# the partitioner and the whole slice under "ell"
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["grid", "rgg"])
def padded(request):
    g = JG.gen_grid(32) if request.param == "grid" else JG.gen_rgg(2000, seed=3)
    jg = JG.pad_graph(g, _pow2(int(g.n)), _pow2(int(g.m)))
    return jg, to_torch(jg)


def test_partition_ell_bitwise(padded):
    """``ell_deg`` pins the refinement's cap AND the coarsening's: 16 here,
    where the padded shapes alone would give another cap."""
    jg, tg = padded
    k, deg = 4, 16
    levels = JP.num_levels(jg.N, k)
    want = JP.partition(jg, k, jnp.float32(0.03), levels, "eco", 5, "ell", deg)
    got = TP.partition(tg, k, 0.03, levels, "eco", 5, "ell", deg, device="cpu")
    assert same(got, want)


def test_partition_host_bitwise(padded):
    jg, tg = padded
    want = JP.partition_host(jg, 3, 0.05, "fast", 7, "ell")
    got = TP.partition_host(tg, 3, 0.05, "fast", 7, "ell", device="cpu")
    assert same(got, want)


HIERARCHIES = [(4, 2), (2, 2, 2)]
D = (1.0, 10.0, 100.0)
INSTANCES = {"grid32": lambda: JG.gen_grid(32), "rgg2000": lambda: JG.gen_rgg(2000, seed=3)}


@pytest.fixture(scope="module")
def ell_results():
    out = {}
    for name, make in INSTANCES.items():
        jg = make()
        tg = to_torch(jg)
        for a in HIERARCHIES:
            d = D[: len(a)]
            jr = jax_shared_map(jg, JHM.Hierarchy(a, d), JConfig(backend="ell"))
            tr = shared_map(tg, THM.Hierarchy(a, d), SharedMapConfig(backend="ell"),
                            device="cpu")
            out[name, a] = (jr, tr)
    return out


@pytest.mark.parametrize("a", HIERARCHIES)
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_shared_map_ell_pe_of_bitwise(ell_results, name, a):
    jr, tr = ell_results[name, a]
    assert tr.stats["backend"] == "ell"
    assert np.array_equal(tr.pe_of, jr.pe_of)
    assert tr.J == pytest.approx(jr.J, rel=1e-6)
    assert tr.stats["partition_calls"] == jr.stats["partition_calls"]
