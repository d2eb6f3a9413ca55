"""The port's plain kernel versions against the JAX package's, on the CPU.

The same numpy inputs go through the JAX oracle (jitted, as the main path
runs it; the JAX package's tests hold these oracles bitwise against its
Pallas kernels in interpret mode) and through ``repro_torch``'s plain
version. The CUDA kernels themselves are held against the plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coarsen import _edge_jitter as jax_edge_jitter
from repro.kernels import ref as jref
from repro_torch.core.coarsen import _edge_jitter
from repro_torch.kernels import ops, ref
from repro_torch.kernels.coarsen_kernels import contract_edges_cuda, hem_propose_cuda
from repro_torch.kernels.flashattn import flash_attention_cuda
from repro_torch.kernels.lp_gain import lp_gain_cuda
from repro_torch.kernels.mapcost import mapcost_cuda
from repro_torch.kernels.powf import fma_f64, libm_powf, near_midpoint, powf_cuda, powf_ref
from repro_torch.kernels.split import gather_rows_cuda

T = torch.from_numpy


def _ell(seed: int, N: int = 600, DEG: int = 32):
    """Random ELL rows: ids in [0, N] (N = padding, self-loops included),
    integer weights, a 0/1 matched vector."""
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, N + 1, (N, DEG))
    adj = np.where(rng.random((N, DEG)) < 0.05, np.arange(N)[:, None], adj).astype(np.int32)
    adw = np.where(adj < N, rng.integers(1, 6, (N, DEG)), 0).astype(np.float32)
    matched = (rng.random(N) < 0.2).astype(np.int32)
    return adj, adw, matched


def _jitter(adj: np.ndarray, salt: int) -> np.ndarray:
    N = adj.shape[0]
    u2d = np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], adj.shape)
    return np.array(jax.jit(jax_edge_jitter)(jnp.asarray(u2d), jnp.asarray(adj),
                                               jnp.int32(salt)))


@pytest.mark.parametrize("salt", [0, 979, 203331])
def test_edge_jitter_bitwise(salt):
    adj = _ell(salt)[0]
    u2d = torch.arange(adj.shape[0], dtype=torch.int32)[:, None].expand(adj.shape)
    got = _edge_jitter(u2d, T(adj), salt).numpy()
    assert np.array_equal(got.view(np.int32), _jitter(adj, salt).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hem_propose_ref_bitwise(seed):
    """Real edge jitter, so the score's single rounding is exercised."""
    adj, adw, matched = _ell(seed)
    jit = _jitter(adj, 979 + seed)
    want = np.asarray(jax.jit(jref.hem_propose_ref)(adj, adw, jit, matched))
    got = ref.hem_propose_ref(T(adj), T(adw), T(jit), T(matched)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_hem_score_rounds_once():
    """Jitted JAX fuses adw * (1 + jj) + jj into one FMA on the CPU: a
    separate multiply and add differ from it, ``fma_f32`` does not."""
    rng = np.random.default_rng(0)
    adj = rng.integers(0, 4096, (4096, 32)).astype(np.int32)
    adw = rng.integers(1, 100, adj.shape).astype(np.float32)
    jit = _jitter(adj, 979)

    def score(w, j):
        jj = j * 1e-3
        return w * (1.0 + jj) + jj
    want = np.asarray(jax.jit(score)(adw, jit))
    jj = T(jit) * torch.tensor(1e-3, dtype=torch.float32)
    fused = ref.fma_f32(T(adw), 1.0 + jj, jj).numpy()
    separate = (T(adw) * (1.0 + jj) + jj).numpy()
    assert np.array_equal(fused.view(np.int32), want.view(np.int32))
    assert (separate != want).sum() > 0


def test_restart_score_rounds_once():
    """partition's ``cut + 1e6 * over`` is fused the same way."""
    rng = np.random.default_rng(1)
    cut = rng.integers(0, 1 << 20, 100_000).astype(np.float32)
    over = (rng.random(100_000) * 100).astype(np.float32)
    want = np.asarray(jax.jit(lambda c, o: c + 1e6 * o)(cut, over))
    got = ref.fma_f32(T(over), torch.tensor(1e6, dtype=torch.float32), T(cut)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_rows_ref_bitwise(dtype):
    rng = np.random.default_rng(3)
    src = rng.integers(-1000, 1000, 777).astype(dtype) / (3 if dtype == np.float32 else 1)
    src = src.astype(dtype)
    idx = rng.integers(-5, 790, (4, 1000)).astype(np.int32)   # out of range: clamped
    want = np.asarray(jax.jit(jref.gather_rows_ref)(src, idx))
    got = ref.gather_rows_ref(T(src), T(idx)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("D2", [16, 64])
def test_contract_edges_ref_bitwise(D2):
    """Non-integer weights, so the fixed add chain's order is exercised."""
    rng = np.random.default_rng(D2)
    N = 500
    cand = rng.integers(0, 40, (N, D2)).astype(np.int32)
    cand[rng.random((N, D2)) < 0.3] = N            # sentinel slots
    candw = np.where(cand < N, rng.random((N, D2)), 0).astype(np.float32)
    want = jax.jit(jref.contract_edges_ref, static_argnums=2)(cand, candw, N)
    got = ref.contract_edges_ref(T(cand), T(candw), N)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        assert np.array_equal(a.numpy().view(np.int32), b.view(np.int32))


def _dedup_live_slots(cand, candw, sent):
    """The CUDA kernel's order (``csrc/contract_edges.cu``): per row, each
    id's first slot s gets +0.0 + candw[s] and then the weights of the later
    slots holding the same id, in increasing slot order; no other slot is
    added, and a duplicate is never visited again."""
    N, D2 = cand.shape
    nbr = np.full_like(cand, sent)
    w = np.zeros_like(candw)
    cnt = np.zeros(N, np.int32)
    for r in range(N):
        live = [j for j in range(D2) if cand[r, j] != sent]
        while live:
            s, x = live[0], cand[r, live[0]]
            acc = np.float32(0.0) + candw[r, s]
            rest = []
            for j in live[1:]:
                if cand[r, j] == x:
                    acc = np.float32(acc + candw[r, j])
                else:
                    rest.append(j)
            live = rest
            nbr[r, s], w[r, s] = x, acc
            cnt[r] += 1
    return nbr, w, cnt


@pytest.mark.parametrize("case", ["random", "sentinel_rows", "one_id", "cross_32"])
@pytest.mark.parametrize("D2", [1, 16, 33, 48, 64, 128])
def test_contract_edges_live_slot_order_is_the_chain(D2, case):
    """Summing only the matching slots in slot order from +0.0 is bitwise the
    reference's fixed chain of D2 adds (which adds +0.0 for every other
    slot), on weights holding +0.0, -0.0 and negative values."""
    rng = np.random.default_rng(D2 * 10 + len(case))
    N = 160
    cand = rng.integers(0, 24, (N, D2)).astype(np.int32)
    if case == "cross_32":   # few ids: repeats across the 32-slot boundaries
        cand = rng.integers(0, 3, (N, D2)).astype(np.int32)
    cand[rng.random((N, D2)) < 0.4] = N
    if case == "sentinel_rows":
        cand[::3] = N
    elif case == "one_id":
        cand[:] = 5
    candw = rng.standard_normal((N, D2)).astype(np.float32)
    candw[rng.random((N, D2)) < 0.15] = 0.0
    candw[rng.random((N, D2)) < 0.15] = -0.0
    want = ref.merge_dedup_rows(T(cand), T(candw), N)
    for a, b in zip(_dedup_live_slots(cand, candw, N), want):
        assert a.dtype == b.numpy().dtype
        assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))


def test_mapcost_ref_rtol():
    rng = np.random.default_rng(4)
    N, M = 900, 5000
    rows = rng.integers(0, N, M).astype(np.int32)
    cols = rng.integers(0, N, M).astype(np.int32)
    ewgt = rng.random(M).astype(np.float32)
    pe = rng.integers(0, 48, N).astype(np.int32)
    gb = np.array([1, 4, 8], np.int32)
    dv = np.array([1.0, 10.0, 100.0], np.float32)
    want = float(jax.jit(jref.mapcost_ref)(rows, cols, ewgt, pe, gb, dv))
    got = float(ref.mapcost_ref(*(T(a) for a in (rows, cols, ewgt, pe, gb, dv))))
    assert got == pytest.approx(want, rel=1e-6)


def test_ops_route_cpu_tensors_to_plain_versions():
    adj, adw, matched = _ell(7)
    jit = _jitter(adj, 5)
    args = (T(adj), T(adw), T(jit), T(matched))
    assert torch.equal(ops.hem_propose(*args), ref.hem_propose_ref(*args))
    cand = T(adj)
    got = ops.contract_edges(cand, T(adw))
    for a, b in zip(got, ref.contract_edges_ref(cand, T(adw), cand.shape[0])):
        assert torch.equal(a, b)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8, dtype=torch.int32)
    f = torch.zeros(8)
    with pytest.raises(ValueError):
        gather_rows_cuda(f, x[None])
    with pytest.raises(ValueError):
        hem_propose_cuda(x[None], f[None], f[None], x[:1])
    with pytest.raises(ValueError):
        contract_edges_cuda(x[None], f[None], 1)
    with pytest.raises(ValueError):
        mapcost_cuda(x, x, f, x, x[:1], f[:1])
    with pytest.raises(ValueError):
        lp_gain_cuda(x[None], f[None], x[:1], 2)
    with pytest.raises(ValueError):
        powf_cuda(f, 1.0 / 3.0)


def test_flash_routes_cpu_to_plain_and_wrapper_refuses_cpu():
    """On the CPU ``ops.flash_attention`` is ``ref.flash_bshd_ref`` on the
    model's layout; the kernel's wrapper takes CUDA tensors only."""
    rng = np.random.default_rng(0)
    q = T(rng.standard_normal((2, 33, 6, 16)).astype(np.float32))
    k, v = (T(rng.standard_normal((2, 33, 3, 16)).astype(np.float32)) for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=True, window=5)
    assert got.shape == q.shape
    assert torch.equal(got, ref.flash_bshd_ref(q, k, v, True, 5))
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("d", [3, 4, 5])
def test_powf_ref_matches_the_c_library(d):
    """The plain version of the powf kernel against the C library's
    ``powf`` (through ctypes, as the reference's XLA program calls it) at
    y = float32(1/d): a seeded sample of 2^16 float32 in [1, 8), and every
    input there whose exact power lies near a float32 rounding midpoint,
    a set that holds every input on which the library and the correctly
    rounded value lie apart. Every float32 in [1, 8) was held once by
    ``python -m repro_torch.kernels.powf`` (0 mismatches at d = 3, 4, 5)."""
    y = float(np.float32(1.0 / d))
    lo, hi = (int(np.float32(v).view(np.uint32)) for v in (1.0, 8.0))
    rng = np.random.default_rng(d)
    parts = [rng.integers(lo, hi, 1 << 16).astype(np.uint32).view(np.float32)]
    for a in range(lo, hi, 1 << 22):
        x = np.arange(a, min(a + (1 << 22), hi), dtype=np.uint32).view(np.float32)
        parts.append(x[near_midpoint(x, y)])
    x = np.concatenate(parts)
    assert x.size > (1 << 16) + 90000
    assert np.array_equal(powf_ref(x, y).view(np.uint32), libm_powf(x, y).view(np.uint32))


@pytest.mark.parametrize("d", [3, 7])
def test_powf_ref_any_float32(d):
    """Random bit patterns (negative, subnormal, huge, NaN) and the special
    values take the C library's branches too; ``ops.powf`` on the CPU is
    the plain version."""
    rng = np.random.default_rng(10 + d)
    x = np.concatenate([rng.integers(0, 2**32, 1 << 15).astype(np.uint32).view(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 1e-40,
                                  -1e-40, -2.0, 3.4e38], np.float32)])
    got, want = powf_ref(x, 1.0 / d), libm_powf(x, 1.0 / d)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))
    t = T(x[ok][:999].reshape(27, 37))
    assert torch.equal(ops.powf(t, 1.0 / d), T(powf_ref(t.numpy(), 1.0 / d)).reshape(27, 37))


def test_fma_f64_rounds_once():
    """``fma_f64`` against the C library's ``fma``, with near cancellations."""
    import ctypes
    import ctypes.util
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.fma.restype = ctypes.c_double
    libm.fma.argtypes = [ctypes.c_double] * 3
    rng = np.random.default_rng(3)
    a, b, c = rng.standard_normal((3, 20000)) * np.exp2(rng.integers(-40, 40, (3, 20000)))
    c = np.where(rng.random(20000) < 0.5, -(a * b) * (1 + 1e-13 * rng.standard_normal(20000)), c)
    want = np.array([libm.fma(*v) for v in zip(a.tolist(), b.tolist(), c.tolist())])
    assert np.array_equal(fma_f64(a, b, c), want)


def test_port_imports_no_jax_and_no_repro():
    code = ("import sys, repro_torch.core.api, repro_torch.kernels.ops, "
            "repro_torch.models.model, repro_torch.models.convert, "
            "repro_torch.serve.engine, repro_torch.configs.registry, "
            "repro_torch.core.baselines, repro_torch.core.taskgraph, repro_torch.faults, "
            "repro_torch.serve.tracker, repro_torch.serve.admission, repro_torch.serve.store, "
            "repro_torch.serve.mapper, repro_torch.serve.supervisor, "
            "repro_torch.launch.hlo_analysis, repro_torch.launch.comm_graph, "
            "repro_torch.launch.mesh, repro_torch.launch.fx_analysis, "
            "repro_torch.launch.train, repro_torch.data.pipeline, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.train.checkpoint, repro_torch.train.compression, "
            "repro_torch.train.fault_tolerance, repro_torch.launch.shardings, "
            "repro_torch.launch.dryrun, repro_torch.models.sharding, repro_torch.models.moe; "
            "[repro_torch.configs.registry.get_config(a) for a in "
            "repro_torch.configs.registry.ARCHS]; "
            "repro_torch.launch.dryrun.ensure_fake_world(256); "
            "repro_torch.launch.mesh.make_production_mesh(device_type='cpu'); "
            "repro_torch.launch.mesh.stop_world(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch.core import graph as G
    from repro_torch.core.api import shared_map
    from repro_torch.core.hierarchy import Hierarchy
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.core.partition import partition
    g = G.gen_grid(6, device="cpu")
    h = Hierarchy((2, 2), (1.0, 10.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        shared_map(g, h)
    with pytest.raises(RuntimeError, match="CUDA"):
        G.gen_grid(6)
    with pytest.raises(RuntimeError, match="CUDA"):
        partition(g, 2, 0.03, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_J(g, h, np.zeros(36, np.int32))
    from repro_torch.core.coarsen import coarsen_cascade
    from repro_torch.core.partition import partition_host
    with pytest.raises(RuntimeError, match="CUDA"):
        partition_host(g, 2, 0.03, coarsen="segment")
    with pytest.raises(RuntimeError, match="CUDA"):
        coarsen_cascade(g, 2)
    from repro_torch.serve.mapper import MappingService
    with pytest.raises(RuntimeError, match="CUDA"):
        MappingService()
    with pytest.raises(RuntimeError, match="CUDA"):
        MappingService(workers=1)
