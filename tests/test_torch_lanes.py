"""Lane batching on the CPU: the port's ``batched_partition`` runs every lane
of a dispatch in one v-cycle and equals the JAX package's vmapped
``batched_partition`` bit for bit; a batch equals its lanes run alone and
every chunking of itself; the plain kernel versions, the coarsening, the
ELL layout, the segmented sums and the split with a lane axis equal their
per-lane calls (and one lane equals the call of one graph).

The lanes are distinct small graphs padded to one bucket (N, M) = (128,
1024): two rgg and a grid of other real sizes, one with float weights, and
a three-vertex path, fewer vertices than blocks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import partition as JP
from repro_torch.core import coarsen as TC
from repro_torch.core import graph as TG
from repro_torch.core import multisection as TM
from repro_torch.core import partition as TP
from repro_torch.core import refine as TR
from repro_torch.kernels import ops, ref

N, M, K = 128, 1024, 4
EPS = [0.03, 0.1, 0.05, 0.2]
SALTS = [7, 1001, 2**31 - 5, 42]   # the third wraps in salt * 131


def _lanes() -> list[TG.Graph]:
    path = TG.from_edges(3, [0, 1], [1, 2], device="cpu")
    gs = [TG.gen_rgg(100, seed=1, device="cpu"), TG.gen_grid(10, device="cpu"),
          TG.float_weights(TG.gen_rgg(120, seed=2, device="cpu"), seed=4), path]
    return [TG.pad_graph(g, N, M) for g in gs]


LANES = _lanes()


def _stack(gs: list[TG.Graph]) -> TG.Graph:
    return TG.Graph(*(torch.stack(f) for f in zip(*gs)))


def _to_jax(g: TG.Graph) -> JG.Graph:
    return JG.Graph(*(jnp.asarray(a.numpy()) for a in g))


BATCH = _stack(LANES)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# (backend, levels, preset, coarsen): levels > 0 and = 0 under both backends
CASES = [("xla", 2, "fast", "ell"), ("ell", 2, "eco", "ell"), ("xla", 0, "fast", "ell"),
         ("ell", 0, "fast", "ell"), ("xla", 1, "fast", "segment")]


@pytest.mark.parametrize("backend,levels,preset,coarsen", CASES)
def test_batched_partition_matches_reference_vmap(backend, levels, preset, coarsen):
    """Every lane of the port's batched v-cycle equals the reference's
    ``vmap`` over the lanes, bit for bit (the n < k lane included)."""
    deg = TG.default_ell_deg(N, M) if backend == "ell" else None
    fn = JP.batched_partition(K, levels, preset, backend, deg, coarsen)
    want = np.asarray(fn(_to_jax(BATCH), jnp.asarray(EPS, jnp.float32),
                         jnp.asarray(SALTS, jnp.int32)))
    got = TP.batched_partition(BATCH, K, torch.tensor(EPS), SALTS, levels, preset, backend,
                               deg, coarsen=coarsen)
    assert got.dtype == torch.int32 and got.shape == (len(LANES), N)
    assert np.array_equal(got.numpy(), want)


def test_batch_equals_lanes_alone_and_every_chunking(monkeypatch):
    """A batch equals every cut of itself into consecutive chunks, one lane
    a chunk included (lanes are independent), and a lane's own
    ``partition`` call."""
    levels, preset, backend = 2, "fast", "xla"
    eps = torch.tensor(EPS)
    whole = TP.batched_partition(BATCH, K, eps, SALTS, levels, preset, backend)
    alone = TP.partition(LANES[2], K, EPS[2], levels, preset, SALTS[2], backend, device="cpu")
    assert _same(whole[2], alone)
    per = TP.lane_bytes(N, M, K, levels, TP.Preset.get(preset).restarts,
                        TG.default_ell_deg(N, M))
    for c in range(1, len(LANES)):
        monkeypatch.setattr(TP, "LANE_CHUNK_BYTES", c * per)
        assert TP.lanes_per_chunk(per) == c
        chunked = TP.batched_partition(BATCH, K, eps, SALTS, levels, preset, backend)
        assert _same(chunked, whole)


def _ell_inputs(seed: int, B: int, n: int, deg: int):
    """Random ELL rows for B lanes: lane-local ids, about a third padding
    (ids >= n, weight 0), small integer and fractional weights."""
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n + n // 2, (B, n, deg)).astype(np.int32)
    adj = np.where(adj >= n, n, adj).astype(np.int32)
    adw = np.where(adj < n, rng.integers(1, 5, adj.shape) / 4.0, 0.0).astype(np.float32)
    return torch.from_numpy(adj), torch.from_numpy(adw), rng


@pytest.mark.parametrize("B", [1, 3])
def test_plain_kernels_with_a_lane_axis_equal_per_lane_calls(B):
    """lp_gain, hem_propose and contract_edges (the plain versions and the
    CPU routes) over [B, ...] equal their calls lane by lane, and a lane's
    call equals the call of one graph."""
    n, deg, R = 40, 8, 2
    adj, adw, rng = _ell_inputs(3, B, n, deg)
    part = torch.from_numpy(rng.integers(0, K, (B, R, n)).astype(np.int32))
    jit = torch.from_numpy(rng.random((B, n, deg)).astype(np.float32))
    matched = torch.from_numpy((rng.random((B, n)) < 0.3).astype(np.int32))
    cand = torch.from_numpy(np.where(rng.random((B, n, 2 * deg)) < 0.4, n,
                                     rng.integers(0, 12, (B, n, 2 * deg))).astype(np.int32))
    candw = torch.from_numpy(rng.random((B, n, 2 * deg)).astype(np.float32))
    lp = ref.lp_gain_ref(adj, adw, part, K)
    hp = ref.hem_propose_ref(adj, adw, jit, matched)
    ce = ref.contract_edges_ref(cand, candw, n)
    for got, want in ((lp, ops.lp_gain(adj, adw, part, K)),
                      ((hp,), (ops.hem_propose(adj, adw, jit, matched),)),
                      (ce, ops.contract_edges(cand, candw))):
        assert all(_same(a, b) for a, b in zip(got, want))
    for b in range(B):
        for got, want in zip(lp, ref.lp_gain_ref(adj[b], adw[b], part[b], K)):
            assert _same(got[b], want)
        for r in range(R):   # one labelling of one graph
            for got, want in zip(lp, ref.lp_gain_ref(adj[b], adw[b], part[b, r], K)):
                assert _same(got[b, r], want)
        assert _same(hp[b], ref.hem_propose_ref(adj[b], adw[b], jit[b], matched[b]))
        for got, want in zip(ce, ref.contract_edges_ref(cand[b], candw[b], n)):
            assert _same(got[b], want)


@pytest.mark.parametrize("ell_deg", [16, None], ids=["ell", "segment"])
def test_coarsen_once_over_lanes_equals_per_lane(ell_deg):
    """One batched coarsening level (matching, contraction) equals each
    lane's own, fields and fine-to-coarse maps bit for bit."""
    gc, newid = TC.coarsen_once(BATCH, salt=138, ell_deg=ell_deg)
    for b, g in enumerate(LANES):
        gc1, newid1 = TC.coarsen_once(g, salt=138, ell_deg=ell_deg)
        assert all(_same(x[b], y) for x, y in zip(gc, gc1))
        assert _same(newid[b], newid1)


def test_graph_routines_over_lanes_equal_per_lane():
    """ell_adjacency, row_label_sums, connectivity, block weights and the
    exact-sums check over a batch equal their per-lane results."""
    rng = np.random.default_rng(9)
    part = torch.from_numpy(rng.integers(0, K, (len(LANES), 2, N)).astype(np.int32))
    adj, adw, over = TG.ell_adjacency(BATCH, 16)
    conn = TR.connectivity(BATCH, part, K)
    W = TR.batched_block_weights(BATCH, part, K)
    for b, g in enumerate(LANES):
        for got, want in zip((adj, adw, over), TG.ell_adjacency(g, 16)):
            assert _same(got[b], want)
        assert _same(conn[b], TR.connectivity(g, part[b], K))
        assert _same(W[b], TR.batched_block_weights(g, part[b], K))
    assert not TG.sums_are_exact(BATCH)   # the float-weighted lane
    assert TG.sums_are_exact(_stack([LANES[0], LANES[1], LANES[3]]))


def test_batched_split_equals_per_lane_split(monkeypatch):
    """The batched split_blocks (and the multisection's chunked _split_op)
    equals each lane's split, children lane-major."""
    arity = 3
    rng = np.random.default_rng(11)
    parts = torch.from_numpy(rng.integers(0, arity, (len(LANES), N)).astype(np.int32))
    sent = torch.tensor(7, dtype=torch.int32)
    orig = torch.where(torch.arange(N) < BATCH.n[:, None], torch.arange(N, dtype=torch.int32),
                       sent)
    ch, co, ws = TG.split_blocks(BATCH, parts, orig, arity, sent)
    assert ch.vwgt.shape == (len(LANES) * arity, N) and ch.n.shape == (len(LANES) * arity,)
    for b, g in enumerate(LANES):
        ch1, co1, ws1 = TG.split_blocks(g, parts[b], orig[b], arity, sent)
        lanes = slice(b * arity, (b + 1) * arity)
        assert all(_same(x[lanes], y) for x, y in zip(ch, ch1))
        assert _same(co[lanes], co1) and _same(ws[lanes], ws1)
    monkeypatch.setattr(TP, "LANE_CHUNK_BYTES", TM.split_lane_bytes(N, M, arity))
    chunked = TM._split_op(BATCH, parts, orig, arity, sent)   # one lane a chunk
    assert all(_same(x, y) for x, y in zip(chunked[0], ch))
    assert _same(chunked[1], co) and _same(chunked[2], ws)
