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
    """graph.label_sums on the card: one result over five runs; the CPU's
    (entry order) on integer weights. On float weights each of the 2^17
    addends a sum takes rounds apart in the two orders; the card's tree is
    held within rtol 1e-5 of the float64 sum (a tree of depth 20 errs by
    at most about 20 float32 roundings)."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    labels = torch.randint(-1, 9, (3, 1 << 20), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 50, (1 << 20,), generator=gen).float()
    if weights == "float":
        w = w * torch.rand(1 << 20, generator=gen)
    runs = [G.label_sums(labels.to(cuda), w.to(cuda), 8) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    if weights == "integer":
        assert torch.equal(runs[0].cpu(), G.label_sums(labels, w, 8))
    else:
        exact = G.label_sums(labels, w.double(), 8)
        torch.testing.assert_close(runs[0].cpu().double(), exact, rtol=1e-5, atol=0.0)


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


def test_auto_is_ell_on_the_card(cuda):
    g = G.gen_grid(16, device="cpu")
    res = shared_map(g, Hierarchy((2, 2), (1.0, 10.0)), SharedMapConfig(), device=cuda)
    assert res.stats["backend"] == "ell"


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
