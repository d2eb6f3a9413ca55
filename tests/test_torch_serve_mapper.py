"""The port's mapping service (``repro_torch.serve.mapper``) on the CPU: the
cases of the JAX package's ``tests/test_serve_mapper.py``, with every
served ``pe_of`` and J held bit for bit against the JAX package's
``shared_map_direct`` on the same graphs, for the bucket, layer, device and
naive strategies and for coalesced bursts; the request fingerprints byte
for byte the reference's for ``Graph`` and ``TaskGraph`` requests; and
``shared_map`` routed through ``install_service``."""
import asyncio
import time

import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map_direct as jax_direct
from repro.core.hierarchy import Hierarchy as JH
from repro.core.taskgraph import TaskGraph as JTaskGraph
from repro.serve.mapper import graph_fingerprint as jax_graph_fp
from repro.serve.mapper import request_fingerprint as jax_request_fp
from repro_torch.core import graph as TG
from repro_torch.core import multisection as TM
from repro_torch.core.api import (SharedMapConfig, current_service, shared_map,
                                  shared_map_direct)
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.serve.mapper import (MappingService, graph_fingerprint, host_view,
                                      request_fingerprint)

H = Hierarchy(a=(4, 2), d=(1.0, 10.0))
JHIER = JH(a=(4, 2), d=(1.0, 10.0))
CFG = SharedMapConfig(preset="fast")


def to_torch(jg) -> TG.Graph:
    return TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in TG.Graph._fields},
                               device="cpu")


@pytest.fixture(scope="module")
def jgraphs():
    return [JG.gen_rgg(300, seed=40 + i) for i in range(4)]


@pytest.fixture(scope="module")
def graphs(jgraphs):
    return [to_torch(jg) for jg in jgraphs]


@pytest.fixture(scope="module")
def reference(jgraphs):
    """``reference(i, cfg)``: the JAX package's direct result for graph i,
    computed once per (graph, config)."""
    memo = {}

    def get(i, cfg):
        key = (i, cfg)
        if key not in memo:
            jcfg = JConfig(**{f: getattr(cfg, f) for f in ("eps", "preset", "strategy",
                                                          "seed", "adaptive", "backend")})
            memo[key] = jax_direct(jgraphs[i], JHIER, jcfg)
        return memo[key]
    return get


def _same(res, ref):
    assert np.array_equal(res.pe_of, ref.pe_of)
    assert res.J == ref.J


@pytest.fixture()
def svc():
    s = MappingService(device="cpu")
    yield s
    s.close()


@pytest.mark.parametrize("strategy", ["bucket", "layer", "device", "naive"])
def test_service_equals_the_reference(graphs, reference, svc, strategy):
    cfg = SharedMapConfig(preset="fast", strategy=strategy)
    r = svc.map(graphs[0], H, cfg)
    _same(r, reference(0, cfg))
    _same(r, shared_map_direct(graphs[0], H, cfg, device="cpu"))
    assert r.stats["backend"] == "xla" and r.stats["result_cache"]["hit"] is False
    again = svc.map(graphs[0], H, cfg)
    assert again.stats["result_cache"]["hit"] is True
    _same(again, r)


@pytest.mark.parametrize("pad", [True, False])
def test_concurrent_requests_bit_identical_and_coalesced(graphs, reference, pad):
    """Cross-request merging must not change any request's result — lanes
    are independent — and must actually merge dispatches."""
    svc = MappingService(cache_entries=0, pad_batch_pow2=pad, device="cpu")
    try:
        futs = svc.submit_many([(g, H, CFG) for g in graphs])
        res = [f.result(timeout=600) for f in futs]
        co = svc.stats()["coalesce"]
    finally:
        svc.close()
    for i, r in enumerate(res):
        _same(r, reference(i, CFG))
    assert co["groups"] > co["dispatches"], co  # merging happened
    assert (co["padded_lanes"] > 0) == pad, co


def test_result_cache_hit_fast_and_identical(graphs, svc):
    first = svc.map(graphs[0], H, CFG)
    assert first.stats["result_cache"]["hit"] is False
    t0 = time.time()
    again = svc.map(graphs[0], H, CFG)
    hit_s = time.time() - t0
    assert again.stats["result_cache"]["hit"] is True
    _same(again, first)
    assert hit_s < 0.1
    # a different seed is a different request
    other = svc.map(graphs[0], H, SharedMapConfig(preset="fast", seed=3))
    assert other.stats["result_cache"]["hit"] is False


def test_result_cache_lru_bound(graphs):
    svc = MappingService(cache_entries=2, device="cpu")
    try:
        for g in graphs[:3]:
            svc.map(g, H, CFG)
        st = svc.stats()["result_cache"]
        assert st["entries"] == 2
        assert st["evictions"] == 1
        r = svc.map(graphs[0], H, CFG)   # the oldest was evicted: recompute
        assert r.stats["result_cache"]["hit"] is False
    finally:
        svc.close()


def test_inflight_dedup(graphs, svc):
    """Identical concurrent requests coalesce onto ONE computation."""
    futs = [svc.submit(graphs[1], H, CFG) for _ in range(3)]
    res = [f.result(timeout=600) for f in futs]
    for r in res[1:]:
        assert np.array_equal(res[0].pe_of, r.pe_of)
    assert svc.stats()["inflight_dedup"] >= 2


def test_fingerprint_ignores_padding(graphs):
    g = graphs[0]
    padded = TG.pad_graph(g, g.N * 2, g.M * 2)
    assert request_fingerprint(g, H, CFG, device="cpu") == \
        request_fingerprint(padded, H, CFG, device="cpu")
    assert request_fingerprint(g, H, CFG, device="cpu") != request_fingerprint(
        g, H, SharedMapConfig(preset="fast", seed=1), device="cpu")


@pytest.mark.parametrize("kind", ["Graph", "TaskGraph"])
@pytest.mark.parametrize("kw", [{}, {"preset": "fast", "seed": 3}, {"backend": "ell"},
                                {"strategy": "device", "eps": 0.05},
                                {"refine_mapping": True, "adaptive": False}])
def test_fingerprints_equal_the_reference_bytes(jgraphs, graphs, kind, kw):
    """On the CPU ``auto`` resolves to ``xla`` in both packages, so the
    bytes agree; a TaskGraph request is keyed by its canonical fingerprint."""
    jg, g = jgraphs[2], graphs[2]
    jtg = ttg = None
    if kind == "TaskGraph":
        jtg, ttg = JTaskGraph.from_graph(jg), TaskGraph.from_graph(g)
        jg, g = jtg.to_graph(), ttg.to_graph(device="cpu")
    cfg = SharedMapConfig(**kw)
    jcfg = JConfig(**kw)
    assert graph_fingerprint(g, H, ttg) == jax_graph_fp(jg, JHIER, jtg)
    assert request_fingerprint(g, H, cfg, ttg, device="cpu") == \
        jax_request_fp(jg, JHIER, jcfg, jtg)
    v = host_view(g)
    assert request_fingerprint(g, H, cfg, ttg, device="cpu", view=v) == \
        jax_request_fp(jg, JHIER, jcfg, jtg)
    assert v.n == int(jg.n) and v.rows.dtype == np.int32 and v.ewgt.dtype == np.float32


def test_taskgraph_request_served_as_its_graph(jgraphs, graphs, svc):
    ttg = TaskGraph.from_graph(graphs[3])
    r = svc.map(ttg, H, CFG)
    jtg = JTaskGraph.from_graph(jgraphs[3])
    _same(r, jax_direct(jtg, JHIER, JConfig(preset="fast")))
    again = svc.map(ttg.to_graph(device="cpu"), H, CFG)   # another key: its CSR
    assert again.stats["result_cache"]["hit"] is False
    _same(again, r)


def test_shared_map_routing(graphs, reference):
    d = shared_map(graphs[2], H, CFG, device="cpu")   # no service installed
    with MappingService(device="cpu") as svc:
        assert current_service() is svc
        r = shared_map(graphs[2], H, CFG, device="cpu")
        assert "result_cache" in r.stats
        _same(r, d)
        _same(r, reference(2, CFG))
        with pytest.raises(ValueError, match="installed mapping service runs on 'cpu'"):
            shared_map(graphs[2], H, CFG, device="cuda")
        with pytest.raises(ValueError, match="installed mapping service"):
            shared_map(graphs[2], H, CFG)   # None = the card
    assert current_service() is None


def test_install_uninstall_and_nesting(graphs):
    a = MappingService(device="cpu")
    b = MappingService(device="cpu")
    try:
        assert a.install() is a and current_service() is a
        with b.installed():
            assert current_service() is b
        assert current_service() is a
        b.uninstall()                      # not installed: no effect
        assert current_service() is a
        a.uninstall()
        assert current_service() is None
    finally:
        a.close()
        b.close()


def test_fallback_strategies_supported(graphs, svc):
    cfg = SharedMapConfig(preset="fast", strategy="queue")
    d = shared_map_direct(graphs[3], H, cfg, device="cpu")
    r = svc.map(graphs[3], H, cfg)
    _same(r, d)
    again = svc.map(graphs[3], H, cfg)
    assert again.stats["result_cache"]["hit"] is True


def test_amap_asyncio(graphs, reference, svc):
    async def run():
        return await asyncio.gather(*(svc.amap(g, H, CFG) for g in graphs[:2]))

    for i, r in enumerate(asyncio.run(run())):
        _same(r, reference(i, CFG))


def test_warmup_counts_the_reference_programs(svc):
    """No program cache to fill: warmup runs each group once, and counts
    what the reference compiles for the same arguments (shapes x ks x ELL
    caps x batch widths)."""
    w = svc.warmup(shapes=[(1024, 8192)], ks=[4], preset="fast", batch_sizes=(2,))
    assert w["programs"] == 1 and w["seconds"] > 0
    w = svc.warmup(shapes=[(64, 256), (128, 512)], ks=[2, 4], preset="fast",
                   batch_sizes=(1, 2), ell_degs=(4, 8))
    assert w["programs"] == 2 * 2 * 2 * 2
    assert svc.stats()["warmup"]["programs"] == 17


def test_device_requests_coalesce(graphs, reference):
    """Same-shape device-strategy requests share exec keys level by level,
    so a concurrent burst merges into shared dispatches — and merging must
    not change any request's labels."""
    cfgs = [SharedMapConfig(preset="fast", strategy="device", seed=s) for s in (1, 2, 3)]
    svc = MappingService(cache_entries=0, device="cpu")
    try:
        futs = svc.submit_many([(graphs[0], H, c) for c in cfgs])
        res = [f.result(timeout=600) for f in futs]
        co = svc.stats()["coalesce"]
    finally:
        svc.close()
    for c, r in zip(cfgs, res):
        _same(r, shared_map_direct(graphs[0], H, c, device="cpu"))
    _same(res[0], reference(0, cfgs[0]))
    assert co["groups"] > co["dispatches"], co


def test_device_single_fetch_through_service(graphs):
    """One array fetch for the multisection labels per request survives
    the service plumbing."""
    cfg = SharedMapConfig(preset="fast", strategy="device")
    svc = MappingService(cache_entries=0, device="cpu")
    try:
        TM.reset_transfer_stats()
        svc.map(graphs[1], H, cfg)
        xf = TM.transfer_stats()
    finally:
        svc.close()
    assert xf["d2h_array_fetches"] == 1, xf


def test_submit_after_close_raises():
    svc = MappingService(device="cpu")
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit(TG.gen_rgg(50, seed=1, device="cpu"), H, CFG)
