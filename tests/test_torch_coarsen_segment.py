"""The remaining core pieces against the JAX package on the CPU, bitwise:
the segment coarsening path (``hem_match``, ``contract``,
``coarsen_once(ell_deg=None)``), ``coarsen_cascade``, ``degrees``,
``quotient_graph_arrays``, ``partition_host(coarsen="segment")`` under both
refinement backends, and ``stats["coarsen"]`` (``coarsen_telemetry``) under
every strategy and with ``refine_mapping``. Grid and rgg instances padded
to power-of-two shapes, with unit and with float weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coarsen as JC
from repro.core import graph as JG
from repro.core import partition as JP
from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map as jax_shared_map
from repro.core.hierarchy import Hierarchy as JH
from repro_torch.core import coarsen as TC
from repro_torch.core import graph as TG
from repro_torch.core import partition as TP
from repro_torch.core.api import SharedMapConfig, shared_map
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.kernels.ref import fma_f32

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


def _padded(name: str):
    """(JAX graph, port graph) padded to powers of two; ``-float`` takes
    ``graph.float_weights`` (vertex and edge weights scaled by seeded
    float32 in [0.5, 1.5)) into both."""
    g = JG.gen_grid(24) if name.startswith("grid") else JG.gen_rgg(900, seed=5)
    jg = JG.pad_graph(g, _pow2(int(g.n)), _pow2(int(g.m)))
    tg = to_torch(jg)
    if name.endswith("float"):
        tg = TG.float_weights(tg, seed=3)
        jg = jg._replace(vwgt=jnp.asarray(tg.vwgt.numpy()), ewgt=jnp.asarray(tg.ewgt.numpy()))
    return jg, tg


@pytest.fixture(scope="module", params=["grid", "rgg", "grid-float", "rgg-float"])
def graphs(request):
    return _padded(request.param)


def test_segment_score_rounds_once():
    """Jitted JAX fuses the segment path's ``w * (1 + j) + j`` into one FMA
    on the CPU: a separate multiply and add differ from it, ``fma_f32``
    does not. ``j`` is the edge jitter times 1e-3, as in ``hem_match``."""
    g = JG.gen_rgg(20000, seed=2)
    ew = (np.random.default_rng(0).integers(1, 100, g.M)).astype(np.float32)

    def score(rows, cols, w):
        j = JC._edge_jitter(rows, cols, 979) * 1e-3
        return w * (1.0 + j) + j
    want = np.asarray(jax.jit(score)(g.rows, g.cols, ew))
    j = TC._edge_jitter(torch.tensor(np.asarray(g.rows)),
                        torch.tensor(np.asarray(g.cols)), 979) * torch.tensor(1e-3)
    fused = fma_f32(torch.from_numpy(ew), 1.0 + j, j).numpy()
    separate = (torch.from_numpy(ew) * (1.0 + j) + j).numpy()
    assert np.array_equal(fused.view(np.int32), want.view(np.int32))
    assert (separate != want).sum() > 0


@pytest.mark.parametrize("L", [1, 16, 17, 32, 33, 1000, 100_003])
def test_xla_order_sums_match_jax(L):
    """``graph.xla_sum`` and ``graph.row_cumsum`` give jitted ``jnp.sum`` and
    ``jnp.cumsum``'s bits on floats whose sums are inexact (the partition's
    Lmax, cut and capacity prefixes take them)."""
    rng = np.random.default_rng(L)
    x = (rng.uniform(0.5, 1.5, (2, L)) * 10.0 ** rng.integers(0, 10, (2, L))).astype(np.float32)
    want_s = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x))
    want_c = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    assert same(TG.xla_sum(torch.from_numpy(x)), want_s)
    assert same(TG.xla_sum(torch.from_numpy(x[0])), want_s[0])
    assert same(TG.row_cumsum(torch.from_numpy(x)), want_c)
    want_c0 = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(x.T.copy()))
    assert same(TG.row_cumsum(torch.from_numpy(x)).T.contiguous(), want_c0)


def test_hem_match_contract_and_coarsen_once_bitwise(graphs):
    jg, tg = graphs
    jit_match = jax.jit(JC.hem_match, static_argnames=("rounds",))
    for salt in (0, 138):
        jl = jit_match(jg, salt=salt)
        tl = TC.hem_match(tg, salt=salt)
        assert same(tl, jl)
        jc, jmap = JC.contract(jg, jl)
        tc, tmap = TC.contract(tg, tl)
        assert same(tmap, jmap)
        for f in FIELDS:
            assert same(getattr(tc, f), getattr(jc, f)), f
    jit_once = jax.jit(JC.coarsen_once, static_argnames=("ell_deg", "rounds"))
    jcur, tcur = jg, tg
    for salt in (269, 400):   # two levels: the second contracts a contracted graph
        jcur, jmap = jit_once(jcur, salt=salt)
        tcur, tmap = TC.coarsen_once(tcur, salt=salt)
        assert same(tmap, jmap)
        for f in FIELDS:
            assert same(getattr(tcur, f), getattr(jcur, f)), f
    assert int(tcur.n) < 0.5 * int(tg.n)


@pytest.mark.parametrize("ell_deg", [None, 8])
def test_coarsen_cascade_bitwise(graphs, ell_deg):
    """The cascade's sizes, and the v-cycle's fine graphs on the same cap."""
    jg, tg = graphs
    lv = 5
    ns, ms = TC.coarsen_cascade(tg, lv, ell_deg=ell_deg, device="cpu")
    jns, jms = JC.coarsen_cascade(jg, lv, ell_deg=ell_deg)
    assert ns.dtype == np.int32 and np.array_equal(ns, np.asarray(jns))
    assert np.array_equal(ms, np.asarray(jms))
    fines, _, coarsest = TP._coarsen_levels(tg, lv, ell_deg)
    sizes = [(int(x.n), int(x.m)) for x in fines[1:] + [coarsest]]
    assert sizes == list(zip(ns.tolist(), ms.tolist()))
    z = TC.coarsen_cascade(tg, 0, device="cpu")
    assert z[0].shape == z[1].shape == (0,)


def test_degrees_and_quotient_graph_arrays_bitwise(graphs):
    jg, tg = graphs
    assert same(TG.degrees(tg), JG.degrees(jg))
    rng = np.random.default_rng(1)
    for k in (3, 8):
        part = rng.integers(0, k, jg.N).astype(np.int32)
        ja, jb = JG.quotient_graph_arrays(jg, jnp.asarray(part), k)
        ta, tb = TG.quotient_graph_arrays(tg, torch.from_numpy(part), k)
        assert same(ta, ja) and same(tb, jb)


@pytest.mark.parametrize("backend", ["xla", "ell"])
@pytest.mark.parametrize("name", ["grid", "rgg"])
def test_partition_host_segment_bitwise(name, backend):
    """Unit weights: the float sums of this path are held by the tests
    above and tests/test_torch_float_weights.py."""
    jg, tg = _padded(name)
    want = JP.partition_host(jg, 4, 0.03, "fast", 1, backend, coarsen="segment")
    got = TP.partition_host(tg, 4, 0.03, "fast", 1, backend, coarsen="segment",
                            device="cpu")
    assert same(got, want)


def test_partition_coarsen_argument_checked():
    g = TG.gen_grid(8, device="cpu")
    with pytest.raises(ValueError, match="coarsen"):
        TP.partition_host(g, 2, 0.03, coarsen="bogus", device="cpu")


TELEMETRY = [{"strategy": "bucket"}, {"strategy": "layer"}, {"strategy": "naive"},
             {"strategy": "queue"}, {"strategy": "device"},
             {"backend": "ell", "strategy": "naive"}, {"refine_mapping": True}]


@pytest.fixture(scope="module")
def telemetry_reference():
    """The reference's ``stats["coarsen"]`` of grid 16x16 on 2:2 (one
    ``shared_map`` run; the dict depends on the graph and the hierarchy
    alone, not on the strategy)."""
    jg = JG.gen_grid(16)
    res = jax_shared_map(jg, JH((2, 2), (1.0, 10.0)), JConfig(preset="fast",
                                                            coarsen_telemetry=True))
    return to_torch(jg), res.stats["coarsen"]


@pytest.mark.parametrize("kw", TELEMETRY, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_coarsen_telemetry_matches_reference(telemetry_reference, kw):
    """``stats["coarsen"]`` is the reference's dict under every strategy and
    with ``refine_mapping``, and the mapping is the one without telemetry
    (which equals the reference's: tests/test_torch_strategies.py)."""
    tg, want = telemetry_reference
    h = Hierarchy((2, 2), (1.0, 10.0))
    got = shared_map(tg, h, SharedMapConfig(preset="fast", coarsen_telemetry=True, **kw),
                     device="cpu")
    plain = shared_map(tg, h, SharedMapConfig(preset="fast", **kw), device="cpu")
    assert got.stats["coarsen"] == want
    assert want["levels"] == len(want["per_level"]) > 0
    assert np.array_equal(got.pe_of, plain.pe_of) and "coarsen" not in plain.stats
