"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; this file imports no JAX, so it runs on a machine with PyTorch for
CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph as G
from repro_torch.core.api import SharedMapConfig, shared_map, shared_map_direct
from repro_torch.core.coarsen import _edge_jitter, contract_candidates, hem_match_ell
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.coarsen_kernels import contract_edges_cuda, hem_propose_cuda
from repro_torch.kernels.flashattn import flash_attention_cuda
from repro_torch.kernels.lp_gain import lp_gain_cuda
from repro_torch.kernels.mapcost import mapcost_cuda
from repro_torch.kernels.powf import near_midpoint, powf_cuda, powf_ref
from repro_torch.kernels.split import gather_rows_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    _build.library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ell(cuda):
    g = G.gen_rgg(3000, seed=5, device=cuda)
    deg = G.default_ell_deg(g.N, g.M)
    adj, adw, _ = G.ell_adjacency(g, deg)
    return g, adj, adw


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_rows_bitwise(cuda, dtype):
    gen = torch.Generator(device="cpu").manual_seed(0)
    src = torch.randint(-2**30, 2**30, (5000,), generator=gen, dtype=torch.int32)
    if dtype == torch.float32:
        src = src.view(torch.float32)   # arbitrary bit patterns, NaNs included
    idx = torch.randint(-10, 5010, (3, 4099), generator=gen, dtype=torch.int32)
    src, idx = src.to(cuda), idx.to(cuda)
    out = gather_rows_cuda(src, idx)
    want = ref.gather_rows_ref(src, idx)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("salt", [979, 7])
def test_hem_propose_bitwise(cuda, ell, salt):
    g, adj, adw = ell
    u2d = torch.arange(g.N, dtype=torch.int32, device=cuda)[:, None].expand(adj.shape)
    jit = _edge_jitter(u2d, adj, salt)
    matched = (torch.arange(g.N, device=cuda) % 7 == 0).to(torch.int32)
    assert torch.equal(hem_propose_cuda(adj, adw, jit, matched),
                       ref.hem_propose_ref(adj, adw, jit, matched))


def test_contract_edges_bitwise(cuda, ell):
    g, adj, adw = ell
    labels = hem_match_ell(g, adj, adw, salt=138)
    _, _, _, cand, candw = contract_candidates(g, labels, adj, adw)
    # non-integer weights exercise the fixed add chain's rounding
    candw = candw * torch.rand(candw.shape, device=cuda)
    got = contract_edges_cuda(cand, candw, cand.shape[0])
    want = ref.contract_edges_ref(cand, candw, cand.shape[0])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mapcost_rtol(cuda, ell):
    g = ell[0]
    gen = torch.Generator(device="cpu").manual_seed(1)
    pe = torch.randint(0, 24, (g.N,), generator=gen, dtype=torch.int32).to(cuda)
    w = (g.ewgt * torch.rand(g.ewgt.shape, device=cuda)).contiguous()
    gb = torch.tensor([1, 4, 8], dtype=torch.int32, device=cuda)
    dv = torch.tensor([1.0, 10.0, 100.0], device=cuda)
    got = float(mapcost_cuda(g.rows, g.cols, w, pe, gb, dv))
    want = float(ref.mapcost_ref(g.rows, g.cols, w, pe, gb, dv))
    assert got == pytest.approx(want, rel=1e-5)


def _hem_inputs(N, DEG, share, padding, seed):
    """ELL rows for hem_propose: ids in [0, N) with some self-loops, padding
    ids (N, and above N) at random slots (``"mid"``) or at the end of each
    row (``"end"``, as ``ell_adjacency`` lays them out); weights and
    jitters from small sets, so many scores tie and the smallest id decides;
    ``share`` of the rows matched."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    adj = torch.randint(0, N, (N, DEG), generator=gen, dtype=torch.int32)
    adj = torch.where(torch.rand(N, DEG, generator=gen) < 0.05,
                      torch.arange(N, dtype=torch.int32)[:, None], adj)
    if padding == "mid":
        adj[torch.rand(N, DEG, generator=gen) < 0.3] = N
        adj[torch.rand(N, DEG, generator=gen) < 0.1] = N + 5
    else:
        live = torch.randint(0, DEG + 1, (N, 1), generator=gen)
        adj = torch.where(torch.arange(DEG)[None] < live, adj, torch.full_like(adj, N))
    adw = torch.where(adj < N, torch.randint(1, 4, (N, DEG), generator=gen).float(), 0.0)
    jit = torch.randint(0, 3, (N, DEG), generator=gen).float() / 2
    matched = (torch.rand(N, generator=gen) < share).to(torch.int32)
    return adj, adw, jit, matched


@pytest.mark.parametrize("share", [0.0, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("DEG", [1, 24, 31, 32, 33, 64])
def test_hem_propose_cases(cuda, DEG, share):
    """Bitwise against the plain version: padding slots mid-row and at the
    ends, shares of matched rows from none to all, N = 1000 (not a multiple
    of a block's 128 rows)."""
    for padding in ("mid", "end"):
        args = [x.to(cuda) for x in _hem_inputs(1000, DEG, share, padding, seed=DEG)]
        got = hem_propose_cuda(*args)
        assert torch.equal(got, ref.hem_propose_ref(*args))
        if share == 1.0:
            assert torch.equal(got, torch.full_like(got, 1000))


@pytest.mark.parametrize("N", [1, 31, 127, 129, 4097, 150_001])
def test_hem_propose_ragged_n_and_real_jitter(cuda, N):
    """Ragged N, and the main path's scores: DEG 24, rows padded at their
    ends, the edge jitter of the first matching round, float weights."""
    adj, adw, _, matched = (x.to(cuda) for x in _hem_inputs(N, 24, 0.3, "end", seed=N))
    adw = adw * torch.rand(adw.shape, device=cuda)
    u2d = torch.arange(N, dtype=torch.int32, device=cuda)[:, None].expand(adj.shape)
    jit = _edge_jitter(u2d, adj, 13)
    assert torch.equal(hem_propose_cuda(adj, adw, jit, matched),
                       ref.hem_propose_ref(adj, adw, jit, matched))


def _mapcost_inputs(cuda, M, N, pe_hi, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(-2, N + 2, (M + 3,), generator=gen, dtype=torch.int32)
    cols = torch.randint(-2, N + 2, (M + 3,), generator=gen, dtype=torch.int32)
    w = torch.rand(M + 3, generator=gen) * 4
    pe = torch.randint(0, pe_hi, (N,), generator=gen, dtype=torch.int32)
    return rows.to(cuda), cols.to(cuda), w.to(cuda), pe.to(cuda)


@pytest.mark.parametrize("M,offset", [(1 << 20, 0), (1 << 20, 1), (100_003, 0), (100_003, 3), (5, 0)])
@pytest.mark.parametrize("levels", ["4:8:6", "3:65537:7"])
def test_mapcost_one_j_within_rtol(cuda, M, offset, levels):
    """J within rtol 1e-5 of the plain version and bitwise one value over
    five runs; edge arrays 16-byte aligned or not (offset), M a multiple of
    4 or not, out-of-range endpoints clamped; group sizes that are not
    powers of two, with PE ids up to 2^31 - 1."""
    a = [int(x) for x in levels.split(":")]
    g_below = torch.tensor([1, a[0], a[0] * a[1]], dtype=torch.int32, device=cuda)
    dv = torch.tensor([1.0, 10.0, 100.0], device=cuda)
    pe_hi = 192 if levels == "4:8:6" else 2**31 - 1
    rows, cols, w, pe = _mapcost_inputs(cuda, M, 5000, pe_hi, seed=M + offset)
    args = (rows[offset:offset + M], cols[offset:offset + M], w[offset:offset + M], pe,
            g_below, dv)
    runs = [mapcost_cuda(*args) for _ in range(5)]
    assert all(torch.equal(r.view(torch.int32), runs[0].view(torch.int32)) for r in runs)
    assert float(runs[0]) == pytest.approx(float(ref.mapcost_ref(*args)), rel=1e-5)


def test_powf_kernel_bitwise(cuda):
    """The powf kernel against its plain version: float32 in [1, 8), the
    inputs there near a rounding midpoint, and random bit patterns."""
    rng = np.random.default_rng(0)
    lo, hi = (int(np.float32(v).view(np.uint32)) for v in (1.0, 8.0))
    x = rng.integers(lo, hi, 1 << 20).astype(np.uint32).view(np.float32)
    for d in (3, 4, 5, 7):
        y = 1.0 / d
        xs = np.concatenate([x, x[near_midpoint(x, y)],
                             rng.integers(0, 2**32, 1 << 16).astype(np.uint32).view(np.float32)])
        got = powf_cuda(torch.from_numpy(xs).to(cuda), y).cpu().numpy()
        want = powf_ref(xs, y)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert np.array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32)), d


@pytest.mark.parametrize("gen", ["grid", "rgg"])
def test_device_strategy_depth3_card_equals_cpu(cuda, gen):
    """The device strategy computes every level's eps on the card; on four
    levels its children at depth 3 reach powf (the kernel launches), and
    its pe_of equals the CPU's, which equals the reference's
    (tests/test_torch_strategies.py)."""
    g = G.gen_grid(32, device="cpu") if gen == "grid" else G.gen_rgg(2000, seed=3, device="cpu")
    h = Hierarchy((2, 2, 2, 2), (1.0, 10.0, 100.0, 1000.0))
    cfg = SharedMapConfig(strategy="device", backend="ell")
    _build.reset_launches()
    on_card = shared_map_direct(g, h, cfg, device=cuda)
    assert _build.LAUNCHES["powf"] > 0
    on_cpu = shared_map_direct(g, h, cfg, device="cpu")
    assert np.array_equal(on_card.pe_of, on_cpu.pe_of)


@pytest.mark.parametrize("weights", ["integer", "float"])
def test_label_sums_fixed_order(cuda, weights):
    """graph.label_sums on the card: one result over five runs, the CPU's
    (entry order) bit for bit, on integer and on float weights."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    labels = torch.randint(-1, 9, (3, 1 << 20), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 50, (1 << 20,), generator=gen).float()
    if weights == "float":
        w = w * torch.rand(1 << 20, generator=gen)
    runs = [G.label_sums(labels.to(cuda), w.to(cuda), 8) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    assert torch.equal(runs[0].cpu(), G.label_sums(labels, w, 8))


def test_row_cumsum_fixed_order(cuda):
    """graph.row_cumsum of a single row on the card (the one-restart
    presets' leftover sweep): one result over five runs."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.rand(1, 1 << 20, generator=gen) * 3).to(cuda)
    runs = [G.row_cumsum(x) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    torch.testing.assert_close(runs[0].double().cpu(), torch.cumsum(x.double().cpu(), -1),
                               rtol=1e-5, atol=0.0)


def test_row_label_sums_card_equals_cpu(cuda):
    """graph.row_label_sums adds each (row, label) in edge order on both
    devices: float weights give the CPU's bits on the card."""
    g = G.float_weights(G.gen_rgg(20000, seed=4, device="cpu"), seed=1)
    g = G.pad_graph(g, 1 << 15, 1 << 18)
    gen = torch.Generator(device="cpu").manual_seed(2)
    part = torch.randint(0, 6, (2, g.N), generator=gen, dtype=torch.int32)
    want = G.row_label_sums(g, part[:, g.cols], g.ewgt, 6)
    gc = g.to(cuda)
    got = G.row_label_sums(gc, part.to(cuda)[:, gc.cols], gc.ewgt, 6)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("backend", ["ell", "xla"])
@pytest.mark.parametrize("gen", ["grid", "rgg"])
def test_float_weights_twice_on_the_card(cuda, gen, backend):
    """Float vertex and edge weights (graph.float_weights): two card runs
    give one pe_of and one J, the card's equals the CPU's."""
    g = G.float_weights(G.gen_grid(32, device="cpu") if gen == "grid"
                        else G.gen_rgg(2000, seed=3, device="cpu"), seed=7)
    h = Hierarchy((4, 2), (1.0, 10.0))
    cfg = SharedMapConfig(backend=backend)
    a, b = (shared_map(g, h, cfg, device=cuda) for _ in range(2))
    assert np.array_equal(a.pe_of, b.pe_of) and a.J == b.J
    assert np.array_equal(a.pe_of, shared_map(g, h, cfg, device="cpu").pe_of)


def test_wrappers_count_launches_and_reject_cpu(cuda, ell):
    g, adj, adw = ell
    before = dict(_build.LAUNCHES)
    gather_rows_cuda(g.ewgt, adj[:2].contiguous())
    assert _build.LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    with pytest.raises(ValueError):
        gather_rows_cuda(g.ewgt.cpu(), adj[:2].contiguous())


@pytest.mark.parametrize("DEG,k,R", [(8, 2, 1), (24, 6, 2), (64, 64, 2), (64, 3, 4), (1, 64, 1)])
@pytest.mark.parametrize("weights", ["integer", "float"])
def test_lp_gain_bitwise(cuda, DEG, k, R, weights):
    """The kernel sums in slot order, as the plain version does: bitwise on
    integer and on float weights."""
    gen = torch.Generator(device="cpu").manual_seed(DEG * k + R)
    N = 3001
    adj = torch.randint(0, N + 1, (N, DEG), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 9, (N, DEG), generator=gen).float()
    if weights == "float":
        w = w * torch.rand((N, DEG), generator=gen)
    adw = torch.where(adj < N, w, 0.0)
    part = torch.randint(0, k, (R, N), generator=gen, dtype=torch.int32)
    args = (adj.to(cuda), adw.to(cuda), part.to(cuda))
    got = lp_gain_cuda(*args, k)
    want = ref.lp_gain_ref(*args, k)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    single = lp_gain_cuda(args[0], args[1], args[2][0].contiguous(), k)
    for a, b in zip(single, got):
        assert torch.equal(a, b[0])


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _lp_gain_inputs(N, DEG, k, R, padding, seed):
    """Random ELL rows with non-integer weights; ``padding`` puts the
    padding ids at random slots, only at the end of each row (as
    ``ell_adjacency`` does), or fills every other row with it."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    adj = torch.randint(0, N, (N, DEG), generator=gen, dtype=torch.int32)
    if padding == "random":
        adj[torch.rand(N, DEG, generator=gen) < 0.6] = N + 7
    elif padding == "end":
        live = torch.randint(0, DEG + 1, (N, 1), generator=gen)
        adj = torch.where(torch.arange(DEG)[None] < live, adj, torch.full_like(adj, N))
    elif padding == "empty_rows":
        adj[::2] = N
    adw = torch.where(adj < N, torch.rand(N, DEG, generator=gen) * 4, 0.0)
    part = torch.randint(0, k, (R, N), generator=gen, dtype=torch.int32)
    return adj, adw, part


@pytest.mark.parametrize("padding", ["random", "end", "empty_rows"])
@pytest.mark.parametrize("k", [4, 6, 8])
def test_lp_gain_main_path_shapes(cuda, k, padding):
    """DEG 24, R 2 as the main path runs it, at a few thousand rows (not a
    multiple of the block's rows)."""
    args = [x.to(cuda) for x in _lp_gain_inputs(4099, 24, k, 2, padding, seed=k)]
    _assert_bitwise(lp_gain_cuda(*args, k), ref.lp_gain_ref(*args, k))


@pytest.mark.parametrize("N", [1, 127, 129, 1000])
def test_lp_gain_all_padding_and_ragged_n(cuda, N):
    """Rows that are all padding take the write-only path: conn 0, best the
    first block other than the row's own, gain 0."""
    gen = torch.Generator(device="cpu").manual_seed(N)
    adj = torch.full((N, 24), N, dtype=torch.int32, device=cuda)
    adw = torch.zeros(N, 24, device=cuda)
    part = torch.randint(0, 6, (2, N), generator=gen, dtype=torch.int32).to(cuda)
    conn, best, gain = lp_gain_cuda(adj, adw, part, 6)
    _assert_bitwise((conn, best, gain), ref.lp_gain_ref(adj, adw, part, 6))
    assert torch.equal(conn, torch.zeros_like(conn))
    assert torch.equal(best, (part == 0).to(torch.int32))
    assert torch.equal(gain.view(torch.int32), torch.zeros_like(best))
    args = [x.to(cuda) for x in _lp_gain_inputs(N, 24, 6, 2, "random", seed=N + 1)]
    _assert_bitwise(lp_gain_cuda(*args, 6), ref.lp_gain_ref(*args, 6))


@pytest.mark.parametrize("padding", ["random", "end"])
def test_lp_gain_k64_r4(cuda, padding):
    """k 64 with four restarts: more sums than one pass holds."""
    args = [x.to(cuda) for x in _lp_gain_inputs(1500, 64, 64, 4, padding, seed=64)]
    _assert_bitwise(lp_gain_cuda(*args, 64), ref.lp_gain_ref(*args, 64))


@pytest.mark.parametrize("k,R", [(4, 3), (5, 1), (8, 3), (9, 2), (33, 1), (64, 3)])
def test_lp_gain_block_counts(cuda, k, R):
    """Block counts on either side of the kernel's routes (sums in registers
    for k <= 4 and k <= 8, in shared memory above), with odd R."""
    args = [x.to(cuda) for x in _lp_gain_inputs(2000, 24, k, R, "random", seed=k * 10 + R)]
    _assert_bitwise(lp_gain_cuda(*args, k), ref.lp_gain_ref(*args, k))


@pytest.mark.parametrize("k,R", [(6, 2), (40, 3), (6, 4), (64, 4)])
def test_lp_gain_large_n(cuda, k, R):
    """Rows for over 2,300 blocks, with even and odd R and up to four
    restarts (two passes of the two restarts a row's lanes take at once)."""
    args = [x.to(cuda) for x in _lp_gain_inputs(150_001, 24, k, R, "end", seed=k + R)]
    _assert_bitwise(lp_gain_cuda(*args, k), ref.lp_gain_ref(*args, k))


def _contract_inputs(N, D2, case, seed):
    """Candidate rows of ``contract_edges`` (sentinel N), with weights that
    hold +0.0, -0.0 and negative values."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cand = torch.randint(0, 24, (N, D2), generator=gen, dtype=torch.int32)
    cand[torch.rand(N, D2, generator=gen) < 0.4] = N
    if case == "sentinel_rows":
        cand[::3] = N
    elif case == "one_id":
        cand[:] = 5
    elif case == "cross_32":
        # few ids, so most rows repeat an id across the 32-slot boundaries
        cand = torch.randint(0, 3, (N, D2), generator=gen, dtype=torch.int32)
    w = torch.randn(N, D2, generator=gen)
    w[torch.rand(N, D2, generator=gen) < 0.15] = 0.0
    w[torch.rand(N, D2, generator=gen) < 0.15] = -0.0
    return cand, w


@pytest.mark.parametrize("case", ["random", "sentinel_rows", "one_id", "cross_32"])
@pytest.mark.parametrize("D2", [1, 16, 33, 48, 64, 128])
def test_contract_edges_cases(cuda, D2, case):
    N = 1000
    cand, w = (x.to(cuda) for x in _contract_inputs(N, D2, case, seed=D2))
    got = contract_edges_cuda(cand, w, N)
    _assert_bitwise(got, ref.contract_edges_ref(cand, w, N))
    if case == "sentinel_rows":
        assert torch.equal(got[0][::3], torch.full_like(cand[::3], N))
        assert torch.equal(got[1][::3].view(torch.int32), torch.zeros_like(cand[::3]))
        assert not got[2][::3].any()


def test_lp_gain_rejects_bad_shapes(cuda, ell):
    _, adj, adw = ell
    part = torch.zeros(adj.shape[0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        lp_gain_cuda(adj, adw, part, 1)            # k < 2
    with pytest.raises(ValueError):
        lp_gain_cuda(adj, adw, part, 65)           # k > 64
    with pytest.raises(ValueError):
        lp_gain_cuda(adj, adw, part.cpu(), 4)      # part on another device


# ---- lane batching: every lane of a dispatch in one launch --------------------

@pytest.mark.parametrize("B,N,k,R", [(3, 4099, 6, 2), (48, 1000, 4, 2), (5, 129, 9, 3),
                                     (2, 1, 64, 1)])
def test_lp_gain_lanes_bitwise(cuda, B, N, k, R):
    """[B, N, DEG] rows and [B, R, N] labels in one launch: bitwise the
    plain version, and each lane equals the launch of that lane alone."""
    lanes = [_lp_gain_inputs(N, 24, k, R, "end" if b % 2 else "random", seed=100 * B + b)
             for b in range(B)]
    adj, adw, part = (torch.stack(f).to(cuda) for f in zip(*lanes))
    before = _build.LAUNCHES["lp_gain"]
    got = lp_gain_cuda(adj, adw, part, k)
    assert _build.LAUNCHES["lp_gain"] == before + 1
    _assert_bitwise(got, ref.lp_gain_ref(adj, adw, part, k))
    for b in range(B):
        one = lp_gain_cuda(adj[b], adw[b], part[b], k)
        _assert_bitwise(tuple(x[b] for x in got), one)


@pytest.mark.parametrize("B,N,DEG", [(3, 1000, 24), (48, 4097, 24), (4, 31, 64)])
def test_hem_propose_lanes_bitwise(cuda, B, N, DEG):
    """[B, N, DEG] in one launch: bitwise the plain version and each lane
    alone (lane-local ids; a row reads only its own lane's flags)."""
    lanes = [_hem_inputs(N, DEG, 0.3 * (b % 3), "mid" if b % 2 else "end", seed=b)
             for b in range(B)]
    adj, adw, jit, matched = (torch.stack(f).to(cuda) for f in zip(*lanes))
    before = _build.LAUNCHES["hem_propose"]
    got = hem_propose_cuda(adj, adw, jit, matched)
    assert _build.LAUNCHES["hem_propose"] == before + 1
    assert torch.equal(got, ref.hem_propose_ref(adj, adw, jit, matched))
    for b in range(B):
        assert torch.equal(got[b], hem_propose_cuda(adj[b], adw[b], jit[b], matched[b]))


@pytest.mark.parametrize("B,D2", [(3, 48), (48, 48), (2, 128)])
def test_contract_edges_lanes_bitwise(cuda, B, D2):
    """[B, N, D2] candidate rows (sentinel N) as the B * N rows of one
    launch: bitwise the plain version and each lane alone."""
    N = 1000
    lanes = [_contract_inputs(N, D2, ("random", "sentinel_rows", "cross_32")[b % 3], seed=b)
             for b in range(B)]
    cand, w = (torch.stack(f).to(cuda) for f in zip(*lanes))
    before = _build.LAUNCHES["contract_edges"]
    got = ops.contract_edges(cand, w)
    assert _build.LAUNCHES["contract_edges"] == before + 1
    _assert_bitwise(got, ref.contract_edges_ref(cand, w, N))
    for b in range(B):
        _assert_bitwise(tuple(x[b] for x in got), contract_edges_cuda(cand[b], w[b], N))


def test_lanes_reject_mismatched_shapes(cuda, ell):
    _, adj, adw = ell
    lanes = adj[None].expand(2, *adj.shape).contiguous()
    lanes_w = adw[None].expand(2, *adw.shape).contiguous()
    part = torch.zeros(3, 2, adj.shape[0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        lp_gain_cuda(lanes, lanes_w, part, 4)       # 3 label lanes for 2 graphs
    with pytest.raises(ValueError):
        lp_gain_cuda(lanes, lanes_w, part[0], 4)    # labels without a lane axis
    with pytest.raises(ValueError):
        hem_propose_cuda(lanes, lanes_w, lanes_w, part[0, 0])   # matched without lanes


@pytest.mark.parametrize("backend", ["ell", "xla"])
def test_batched_dispatch_equals_lanes_alone_on_the_card(cuda, backend):
    """One batched_partition of four lanes on the card equals each lane's
    own partition call on the card and the CPU's batch, and launches each
    kernel as often as one lane alone does."""
    from repro_torch.core.partition import batched_partition, partition
    N, M, k, levels = 256, 2048, 4, 2
    path = G.from_edges(3, [0, 1], [1, 2], device="cpu")
    lanes = [G.pad_graph(g, N, M) for g in (
        G.gen_rgg(200, seed=1, device="cpu"), G.gen_grid(14, device="cpu"),
        G.float_weights(G.gen_rgg(230, seed=2, device="cpu"), seed=4), path)]
    batch = G.Graph(*(torch.stack(f) for f in zip(*lanes)))
    eps, salts = [0.03, 0.1, 0.05, 0.2], [7, 1001, 2**31 - 5, 42]
    deg = G.default_ell_deg(N, M) if backend == "ell" else None
    want = batched_partition(batch, k, torch.tensor(eps), salts, levels, "eco", backend, deg)
    _build.reset_launches()
    got = batched_partition(batch.to(cuda), k, torch.tensor(eps, device=cuda), salts,
                            levels, "eco", backend, deg)
    batched = dict(_build.LAUNCHES)
    assert torch.equal(got.cpu(), want)
    for b, g in enumerate(lanes):
        _build.reset_launches()
        one = partition(g, k, eps[b], levels, "eco", salts[b], backend, deg, device=cuda)
        assert torch.equal(one.cpu(), want[b])
        assert dict(_build.LAUNCHES) == batched
    if backend == "ell":
        assert batched["lp_gain"] > 0 and batched["contract_edges"] == levels


@pytest.mark.parametrize("backend", ["ell", "xla"])
@pytest.mark.parametrize("gen", ["grid", "rgg"])
def test_shared_map_card_equals_cpu(cuda, gen, backend):
    """The backend pinned on both sides: "auto" is "ell" on the card and
    "xla" on the CPU."""
    g = G.gen_grid(24, device="cpu") if gen == "grid" else G.gen_rgg(1500, seed=2, device="cpu")
    h = Hierarchy((4, 2), (1.0, 10.0))
    _build.reset_launches()
    on_card = shared_map(g, h, SharedMapConfig(backend=backend), device=cuda)
    used = {k for k, v in _build.LAUNCHES.items() if v > 0}
    mapping = set(_build.LAUNCHES) - {"flash_attention", "powf"}   # not on this path
    assert used == mapping - ({"lp_gain"} if backend == "xla" else set())
    on_cpu = shared_map(g, h, SharedMapConfig(backend=backend), device="cpu")
    assert np.array_equal(on_card.pe_of, on_cpu.pe_of)
    assert on_card.J == pytest.approx(on_cpu.J, rel=1e-6)


QUALITY = ["shared_map(tg)", "refine_mapping", "global_multisection", "kaffpa_map_style",
           "greedy_baseline"]


def _quality_run(alg, g, h, backend, device):
    """One algorithm of the paper's quality comparison, as ``(pe_of, J)``."""
    from repro_torch.core import baselines as B
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.core.taskgraph import TaskGraph
    if alg in ("shared_map(tg)", "refine_mapping"):
        cfg = SharedMapConfig(backend=backend, refine_mapping=alg == "refine_mapping")
        r = shared_map(TaskGraph.from_graph(g), h, cfg, device=device)
        return r.pe_of, r.J
    if alg == "greedy_baseline":
        pe = B.greedy_baseline(g, h, device=device)
        return pe, evaluate_J(g, h, pe, device=device)
    r = getattr(B, alg)(g, h, backend=backend, device=device)
    return r.pe_of, r.stats["J_after_refine"]


@pytest.mark.parametrize("alg", QUALITY)
@pytest.mark.parametrize("backend", ["ell", "xla"])
@pytest.mark.parametrize("gen", ["grid", "rgg"])
def test_quality_comparison_card_equals_cpu(cuda, gen, backend, alg):
    """The baselines and refine_mapping on the card against the CPU, the
    refinement backend pinned on both sides: the same pe_of, dtype
    included; J within mapcost's rtol."""
    g = G.gen_grid(32, device="cpu") if gen == "grid" else G.gen_rgg(2000, seed=3, device="cpu")
    h = Hierarchy((4, 2), (1.0, 10.0))
    _build.reset_launches()
    pe_card, j_card = _quality_run(alg, g, h, backend, cuda)
    if alg in ("global_multisection", "kaffpa_map_style"):
        used = {k for k, v in _build.LAUNCHES.items() if v > 0}
        mapping = set(_build.LAUNCHES) - {"flash_attention", "powf"}
        assert used == mapping - ({"lp_gain"} if backend == "xla" else set())
    pe_cpu, j_cpu = _quality_run(alg, g, h, backend, "cpu")
    assert pe_card.dtype == pe_cpu.dtype and np.array_equal(pe_card, pe_cpu)
    assert j_card == pytest.approx(j_cpu, rel=1e-5)


@pytest.mark.parametrize("gen", ["grid", "rgg", "rgg-float"])
def test_taskgraph_to_graph_on_the_card_bitwise(cuda, gen):
    from repro_torch.core.taskgraph import TaskGraph
    g = G.gen_grid(32, device="cpu") if gen == "grid" else G.gen_rgg(2000, seed=3, device="cpu")
    if gen == "rgg-float":
        g = G.float_weights(g, seed=7)
    tg = TaskGraph.from_graph(g.to(cuda))
    assert tg.fingerprint() == TaskGraph.from_graph(g).fingerprint()
    on_card, on_cpu = tg.to_graph(device=cuda), tg.to_graph(device="cpu")
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    assert tg.to_graph(device=cuda) is on_card and tg.to_graph(device="cpu") is on_cpu
    for f in G.Graph._fields:
        a, b = getattr(on_card, f).cpu(), getattr(on_cpu, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_auto_is_ell_on_the_card(cuda):
    g = G.gen_grid(16, device="cpu")
    res = shared_map(g, Hierarchy((2, 2), (1.0, 10.0)), SharedMapConfig(), device=cuda)
    assert res.stats["backend"] == "ell"


MAPPING_KERNELS = ("gather_rows", "hem_propose", "contract_edges", "mapcost", "lp_gain")


@pytest.mark.parametrize("strategy", ["bucket", "device"])
def test_service_on_the_card_equals_the_direct_path(cuda, strategy):
    """``shared_map`` through an installed service on the card: the direct
    path's result on the card, through the five mapping kernels; a burst of
    three coalesces and changes nothing; warmup loads the kernel library."""
    from repro_torch.serve.mapper import MappingService
    h = Hierarchy((4, 2), (1.0, 10.0))
    cfg = SharedMapConfig(preset="fast", strategy=strategy)
    gs = [G.gen_rgg(3000, seed=s, device=cuda) for s in (5, 6, 7)]
    want = [shared_map_direct(g, h, cfg, device=cuda) for g in gs]
    with MappingService(cache_entries=0, device=cuda) as svc:
        w = svc.warmup(shapes=[(1024, 8192)], ks=[4], preset="fast", batch_sizes=(2,))
        assert w["programs"] == 1 and _build._LIB is not None
        torch.cuda.synchronize()
        _build.reset_launches()
        got = shared_map(gs[0], h, cfg, device=cuda)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        burst = [f.result(timeout=600) for f in svc.submit_many([(g, h, cfg) for g in gs])]
        co = svc.stats()["coalesce"]
    assert got.stats["backend"] == "ell"
    assert all(launches[k] > 0 for k in MAPPING_KERNELS), launches
    for r, d in zip([got] + burst, want[:1] + want):
        assert np.array_equal(r.pe_of, d.pe_of) and r.J == d.J
    assert co["groups"] > co["dispatches"], co


def test_worker_mode_on_the_card(cuda):
    """A ``workers=1`` service on the card: the worker resolves ``auto`` to
    ``ell`` (it ran on the card) and returns the direct path's ``pe_of``; a
    CUDA pool refuses ``fork``."""
    from repro_torch.serve.mapper import MappingService
    h = Hierarchy((4, 2), (1.0, 10.0))
    cfg = SharedMapConfig(preset="fast")
    g = G.gen_rgg(3000, seed=5, device=cuda)
    want = shared_map_direct(g, h, cfg, device=cuda)
    with MappingService(workers=1, device=cuda) as svc:
        got = svc.map(g, h, cfg)
    assert got.stats["backend"] == "ell"
    assert np.array_equal(got.pe_of, want.pe_of) and got.J == want.J
    with pytest.raises(ValueError, match="fork"):
        MappingService(workers=1, worker_kwargs={"ctx": "fork"}, device=cuda)


# flash against its plain version, as (rtol, atol), the same as chip_smoke.py's
# FLASH_TOL: both compute in f32 and round the output once to the input type,
# so in bf16 they may differ by one rounding step (rtol 2^-7 is one bf16 ulp
# of the value; atol covers f32 summation order near zero). f32 differs only
# in the order of the sums.
FLASH_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0**-7, 1e-4)}


def _flash_qkv(cuda, B, S, H, Hkv, D, dtype, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(B, S, h, D, generator=gen).to(cuda, dtype) for h in (H, Hkv, Hkv)]


def _assert_flash_close(got, want, dtype):
    rtol, atol = FLASH_TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [12, 64, 128, 256])
@pytest.mark.parametrize("Hkv", [6, 2], ids=["mha", "gqa3"])
@pytest.mark.parametrize("S,causal,window", [
    (300, True, 0),       # ragged S, causal
    (129, False, 0),      # ragged S, one row past a tile, no mask
    (300, True, 17),      # window below the tile size
    (300, False, 64),     # window without causal
    (1, True, 0),         # a single row
])
def test_flash_attention_matches_plain(cuda, dtype, D, Hkv, S, causal, window):
    """The kernel reads q [B, S, H, D] and k/v [B, S, Hkv, D] in place."""
    q, k, v = _flash_qkv(cuda, 2, S, 6, Hkv, D, dtype, seed=D * 1000 + S + window + Hkv)
    got = flash_attention_cuda(q, k, v, causal, window)
    _assert_flash_close(got, ref.flash_bshd_ref(q, k, v, causal, window), dtype)


def test_flash_attention_long_window(cuda):
    """A window of 4096 (mixtral's) over a longer sequence: the first
    k-tiles of late rows lie wholly outside the band and are skipped."""
    q, k, v = _flash_qkv(cuda, 2, 4700, 3, 1, 128, torch.bfloat16, seed=4096)
    got = flash_attention_cuda(q, k, v, True, 4096)
    _assert_flash_close(got, ref.flash_bshd_ref(q, k, v, True, 4096), torch.bfloat16)


def test_flash_attention_gqa_route_counts(cuda):
    """ops.flash_attention hands the model's layout to the kernel (one
    launch per call, no copy) and matches the CPU's route; a dtype mismatch
    and a strided view raise."""
    B, S, H, Hkv, D = 2, 200, 6, 2, 64
    q, k, v = _flash_qkv(cuda, B, S, H, Hkv, D, torch.float32, seed=5)
    before = _build.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k.half(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert _build.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.parametrize("weights", ["unit", "float"])
@pytest.mark.parametrize("backend", ["ell", "xla"])
def test_segment_partition_card_equals_cpu(cuda, backend, weights):
    """partition_host(coarsen="segment") on the card gives the CPU's
    partition; on float weights two card runs give one."""
    from repro_torch.core.partition import partition_host
    g = G.gen_rgg(4000, seed=2, device="cpu")
    if weights == "float":
        g = G.float_weights(g, seed=5)
    want = partition_host(g, 4, 0.03, "fast", 1, backend, coarsen="segment", device="cpu")
    runs = [partition_host(g, 4, 0.03, "fast", 1, backend, coarsen="segment", device=cuda)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0].cpu(), want)


def test_float_contract_and_quotient_one_answer(cuda):
    """The segment path's float sums by label (contract's vertex and edge
    weights, quotient_graph_arrays) run in entry order on the card: two runs
    give one answer, the CPU's."""
    from repro_torch.core.coarsen import contract, hem_match
    g = G.float_weights(G.gen_rgg(20000, seed=4, device="cpu"), seed=1)
    gd = g.to(cuda)
    part = torch.randint(0, 7, (g.N,), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    want_c = contract(g, hem_match(g, salt=5))
    want_q = G.quotient_graph_arrays(g, part, 7)
    for _ in range(2):
        gc, newid = contract(gd, hem_match(gd, salt=5))
        assert torch.equal(newid.cpu(), want_c[1])
        for a, b in zip(gc, want_c[0]):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(G.quotient_graph_arrays(gd, part.to(cuda), 7), want_q):
            assert torch.equal(a.cpu(), b)


def test_xla_order_sums_card_equals_cpu(cuda):
    """graph.xla_sum and graph.row_cumsum add in one fixed order (XLA's CPU
    order) on both devices: float values over a wide range give the CPU's
    bits on the card."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    x = torch.rand(3, 100_003, generator=gen) * 10.0 ** torch.randint(0, 9, (3, 100_003),
                                                                      generator=gen)
    assert torch.equal(G.xla_sum(x.to(cuda)).cpu(), G.xla_sum(x))
    assert torch.equal(G.row_cumsum(x.to(cuda)).cpu(), G.row_cumsum(x))


def test_label_sums_card_equals_cpu(cuda):
    """Undeclared, the card adds each label's float weights in entry order
    (segment_sum): the CPU's bits. Under exact_sums of a unit-weight graph
    the masked reduction gives the same bits on integer weights."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    labels = torch.randint(-1, 9, (2, 300_000), generator=gen, dtype=torch.int32)
    w = torch.rand(300_000, generator=gen) * 10.0 ** torch.randint(0, 9, (300_000,),
                                                                   generator=gen)
    assert torch.equal(G.label_sums(labels.to(cuda), w.to(cuda), 8).cpu(),
                       G.label_sums(labels, w, 8))
    wi = torch.randint(1, 50, (300_000,), generator=gen).float()
    g = G.gen_rgg(3000, seed=1, device=cuda)
    assert G.sums_are_exact(g) and not G.sums_are_exact(G.float_weights(g, seed=2))
    with G.exact_sums(g):
        got = G.label_sums(labels.to(cuda), wi.to(cuda), 8)
    assert torch.equal(got.cpu(), G.label_sums(labels, wi, 8))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_initial_partition_seeds_card_equals_cpu(cuda, n):
    """Fewer vertices than blocks: seeds share vertices, and the card keeps
    the CPU's (the reference's) last-written seed, not whichever write
    lands last."""
    from repro_torch.core.initial import initial_partition
    g = G.from_edges(n, np.arange(n - 1), np.arange(1, n), N=8, M=8, device="cpu")
    for salt in (0, 5, 12):
        want = initial_partition(g, 16, torch.tensor(100.0), salt=salt, backend="xla")
        got = initial_partition(g.to(cuda), 16, torch.tensor(100.0, device=cuda), salt=salt,
                                backend="xla")
        assert torch.equal(got.cpu(), want)


# ---- the model zoo on the card ---------------------------------------------------

ZOO = ("moonshot-v1-16b-a3b", "mixtral-8x22b", "jamba-v0.1-52b", "xlstm-125m",
       "whisper-tiny", "internvl2-76b")


def _zoo_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, S)))}
    if cfg.frontend == "vision_stub":
        b["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.02).to(torch.bfloat16)
    if cfg.is_encoder_decoder:
        b["frames"] = torch.as_tensor(
            rng.standard_normal((B, S, cfg.d_model)) * 0.02).to(torch.bfloat16)
    return b


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_smoke_prefill_card_equals_cpu(cuda, arch):
    """Each family's smoke prefill (flash where the family takes it) on the
    card against the CPU's plain route, at the whole path's bf16 tolerance
    (atol 0.15, rtol 0.1; chip_smoke.py's LOGITS_ATOL/RTOL)."""
    import copy
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as MM
    from repro_torch.models.sharding import ShardCtx
    cfg = get_smoke_config(arch)
    p = MM.init_fn(cfg, torch.Generator(device="cpu").manual_seed(0))
    b = _zoo_batch(cfg, 2, 64, seed=1)
    ctx = ShardCtx(use_flash=True)
    want = MM.prefill_fn(cfg, p, b, ctx)
    before = _build.LAUNCHES["flash_attention"]
    got = MM.prefill_fn(cfg, copy.deepcopy(p).to(cuda), {k: v.to(cuda) for k, v in b.items()},
                        ctx)
    flash = _build.LAUNCHES["flash_attention"] - before
    assert flash == (0 if arch in ("xlstm-125m", "whisper-tiny") else
                     sum(k.startswith("attn") for k in cfg.layer_kinds())
                     * (cfg.num_layers // len(cfg.layer_kinds())))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.device.type == "cuda" and g.dtype == w.dtype == torch.bfloat16
        torch.testing.assert_close(g.cpu().float(), w.float(), atol=0.15, rtol=0.1)


def test_moe_combine_on_the_card(cuda):
    """The expert-by-expert combine: one result over two card runs, equal
    output rows for duplicate token rows, and the CPU's within bf16
    rounding."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    p = moe.moe_params(cfg, torch.Generator(device="cpu").manual_seed(3))
    gen = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn(40, cfg.d_model, generator=gen).repeat(3, 1).to(torch.bfloat16)  # 3 copies
    args = [p["router"]] + [p[k][0].to(torch.bfloat16) for k in ("w_gate", "w_up", "w_down")]
    runs = [moe.moe_ffn_shard(cfg, x.to(cuda), *(a.to(cuda) for a in args)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:40], runs[0][40:80]) and torch.equal(runs[0][:40], runs[0][80:])
    want = moe.moe_ffn_shard(cfg, x, *args)
    torch.testing.assert_close(runs[0].cpu().float(), want.float(), atol=0.05, rtol=0.05)
