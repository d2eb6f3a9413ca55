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
from repro_torch.core.api import SharedMapConfig, shared_map
from repro_torch.core.coarsen import _edge_jitter, contract_candidates, hem_match_ell
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.coarsen_kernels import contract_edges_cuda, hem_propose_cuda
from repro_torch.kernels.flashattn import flash_attention_cuda
from repro_torch.kernels.lp_gain import lp_gain_cuda
from repro_torch.kernels.mapcost import mapcost_cuda
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
    mapping = set(_build.LAUNCHES) - {"flash_attention"}   # the model path's kernel
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
