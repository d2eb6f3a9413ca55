"""The port's Mamba (``repro_torch.models.mamba``) and xLSTM
(``repro_torch.models.xlstm``) against the JAX package, on the CPU; then
the ssm (xlstm) smoke model whole.

Modules in f32, where only the order of the sums differs (``jnp.cumsum``
over a chunk adds in blocks of 16, ROADMAP "Semantics"; the einsums
contract in other orders): atol 2e-5 with rtol 1e-5 for outputs of order
one. The associative scan over chunks is the reference's algorithm and is
held bit for bit. The model in bf16 at the reference's own tolerance
(``torch_families``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as tf
from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro.models import xlstm as JXL
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import model as M
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx

T = torch.from_numpy
F32_ATOL, F32_RTOL = 2e-5, 1e-5


def _cfgs(arch, **kw):
    cfg_j = dataclasses.replace(jreg.get_smoke_config(arch), **kw)
    return cfg_j, ModelConfig(**dataclasses.asdict(cfg_j))


def _group(p):
    return torch.nn.ParameterDict({k: L.param(T(np.array(v, np.float32)))
                                   for k, v in p.items()})


def _close(got, want, atol=F32_ATOL, rtol=F32_RTOL, what=""):
    np.testing.assert_allclose(tf.np32(got), tf.np32(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---- shared pieces ------------------------------------------------------------------

def test_softplus_and_log_sigmoid_f32():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every x (torch's
    ``F.softplus`` turns linear above 20); ``log_sigmoid`` is its mirror."""
    x = np.concatenate([np.linspace(-60, 60, 2001), [-1e4, 1e4, 0.0, 19.9, 20.1]]
                       ).astype(np.float32)
    _close(L.softplus(T(x)), jax.nn.softplus(x), atol=1e-6, rtol=1e-6)
    _close(L.log_sigmoid(T(x)), jax.nn.log_sigmoid(x), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 13])
def test_associative_scan_bitwise(n):
    """The scan over chunks combines in the reference's order: bit for bit
    the reference run op by op (under ``jit`` XLA fuses ``a * b + c`` into
    one FMA, which the f32 tolerances of the modules cover)."""
    def combine(a, b):
        A1, S1, v1 = a
        A2, S2, v2 = b
        return A1 * A2, A2[..., None, None] * S1 + S2, A2[..., None] * v1 + v2
    rng = np.random.default_rng(n)
    A = rng.random((2, n, 3)).astype(np.float32)
    S = rng.standard_normal((2, n, 3, 4, 5)).astype(np.float32)
    v = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    got = L.associative_scan(combine, (T(A), T(S), T(v)), dim=1)
    want = jax.lax.associative_scan(combine, (A, S, v), axis=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_softmax_xent_f32():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        got = L.softmax_xent(T(logits), T(labels), None if m is None else T(m))
        want = JL.softmax_xent(logits, labels, m)
        _close(got, want, atol=1e-6, rtol=1e-6)


# ---- Mamba --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    cfg_j, cfg = _cfgs("jamba-v0.1-52b")
    p = jax.tree.map(np.asarray, JMB.mamba_params(cfg_j, jax.random.PRNGKey(3)))
    p["b_dt"] = p["b_dt"] + np.linspace(-1, 1, p["b_dt"].size, dtype=np.float32)
    p["A_log"] = p["A_log"] + np.linspace(-0.5, 0.5, p["A_log"].size, dtype=np.float32)
    return cfg_j, cfg, p


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_f32(state):
    u = _x((2, 9, 12), 1)
    w = _x((4, 12), 2)
    st = _x((2, 3, 12), 3) if state else None
    got, got_st = MB._causal_conv(T(u), T(w), None if st is None else T(st))
    want, want_st = JMB._causal_conv(u, w, st)
    _close(got, want)
    _close(got_st, want_st)


@pytest.mark.parametrize("S,chunk", [(16, 16), (48, 16), (40, 8)])
def test_ssd_chunked_f32(S, chunk):
    """1, 3 and 5 chunks: the scan's odd and even recursion."""
    Bsz, H, P, N = 2, 3, 8, 4
    X = _x((Bsz, S, H, P), 4)
    B_, C_ = _x((Bsz, S, N), 5), _x((Bsz, S, N), 6)
    lamb = -np.abs(_x((Bsz, S, H), 7, 0.3))
    got = MB._ssd_chunked(T(X), T(B_), T(C_), T(lamb), chunk)
    want = jax.jit(JMB._ssd_chunked, static_argnums=4)(X, B_, C_, lamb, chunk)
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("S,chunk", [(16, 128), (24, 8)])
def test_apply_mamba_f32(mamba, S, chunk):
    cfg_j, cfg, p = mamba
    x = _x((2, S, cfg.d_model), 8)
    got = MB.apply_mamba(cfg, _group(p), T(x), chunk=chunk)
    want = jax.jit(lambda p_, x_: JMB.apply_mamba(cfg_j, p_, x_, chunk=chunk))(p, x)
    _close(got, want)


def test_decode_mamba_f32(mamba):
    """Decode steps against the reference's, and the last step's output
    against the prefill of the same positions."""
    cfg_j, cfg, p = mamba
    B, S = 2, 10
    xs = _x((B, S, cfg.d_model), 9)
    st = MB.mamba_state_init(cfg, B)
    jst = JMB.mamba_state_init(cfg_j, B)
    tp = _group(p)
    jstep = jax.jit(lambda p_, x_, s_: JMB.decode_mamba(cfg_j, p_, x_, s_))
    for t in range(S):
        out, st = MB.decode_mamba(cfg, tp, T(xs[:, t:t + 1]), st)
        jout, jst = jstep(p, xs[:, t:t + 1], jst)
        _close(out, jout, what=f"step {t}")
        for k in ("h", "conv"):
            _close(st[k], jst[k], what=k)
    full = MB.apply_mamba(cfg, tp, T(xs), chunk=S // 2)
    _close(full[:, -1:], out, atol=1e-4)


def test_decode_mamba_bf16_conv_state(mamba):
    """In bf16 the reference's conv state turns bf16 after one step; the
    port's f32 state holds the same values and the outputs are equal."""
    cfg_j, cfg, p = mamba
    B = 2
    xs = _x((B, 3, cfg.d_model), 10)
    st = MB.mamba_state_init(cfg, B)
    jst = JMB.mamba_state_init(cfg_j, B)
    jstep = jax.jit(lambda p_, x_, s_: JMB.decode_mamba(cfg_j, p_, x_, s_))
    for t in range(3):
        out, new = MB.decode_mamba(cfg, _group(p), T(xs[:, t:t + 1]).to(torch.bfloat16), st)
        for k in st:
            st[k].copy_(new[k])
        jout, jst = jstep(p, jnp.asarray(xs[:, t:t + 1], jnp.bfloat16), jst)
        assert st["conv"].dtype == torch.float32 and jst["conv"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(st["conv"].numpy(), tf.np32(jst["conv"]))
        _close(out, jout, atol=0.02, rtol=0.02, what=f"step {t}")


# ---- xLSTM ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm():
    cfg_j, cfg = _cfgs("xlstm-125m")
    pm = jax.tree.map(np.asarray, JXL.mlstm_params(cfg_j, jax.random.PRNGKey(4)))
    pm["wi"] = pm["wi"] * 50.0     # input gates of order one: the clip and the
    pm["wf"] = pm["wf"] * 50.0     # stabiliser are exercised
    ps = jax.tree.map(np.asarray, JXL.slstm_params(cfg_j, jax.random.PRNGKey(5)))
    ps["b"] = _x(ps["b"].shape, 11, 0.5)
    return cfg_j, cfg, pm, ps


@pytest.mark.parametrize("S,chunk", [(8, 256), (24, 8)])
def test_apply_mlstm_f32(xlstm, S, chunk):
    cfg_j, cfg, pm, _ = xlstm
    x = _x((2, S, cfg.d_model), 12)
    got = XL.apply_mlstm(cfg, _group(pm), T(x), chunk=chunk)
    want = jax.jit(lambda p_, x_: JXL.apply_mlstm(cfg_j, p_, x_, chunk=chunk))(pm, x)
    _close(got, want, atol=1e-4, rtol=1e-4)


def test_mlstm_bf16_sqrt_rounding():
    """The prefill divides k by sqrt(P) in the compute dtype: bf16
    sqrt(192) = 13.875; the decode by the f32 sqrt (13.856...)."""
    P = 768 // 4
    got = torch.tensor(math.sqrt(P), dtype=torch.float32).to(torch.bfloat16)
    want = jnp.sqrt(P).astype(jnp.bfloat16)
    assert float(got) == float(want) == 13.875
    assert np.float32(math.sqrt(P)) == np.asarray(jnp.sqrt(P))


def test_decode_mlstm_f32(xlstm):
    cfg_j, cfg, pm, _ = xlstm
    B, S = 2, 9
    xs = _x((B, S, cfg.d_model), 13)
    st, jst = XL.mlstm_state_init(cfg, B), JXL.mlstm_state_init(cfg_j, B)
    tp = _group(pm)
    jstep = jax.jit(lambda p_, x_, s_: JXL.decode_mlstm(cfg_j, p_, x_, s_))
    for t in range(S):
        out, st = XL.decode_mlstm(cfg, tp, T(xs[:, t:t + 1]), st)
        jout, jst = jstep(pm, xs[:, t:t + 1], jst)
        _close(out, jout, atol=1e-4, rtol=1e-4, what=f"step {t}")
        for k in st:
            _close(st[k], jst[k], atol=1e-4, rtol=1e-4, what=k)


@pytest.mark.parametrize("time_chunk", [1, 4])
def test_apply_slstm_f32(xlstm, time_chunk):
    cfg_j, cfg, _, ps = xlstm
    x = _x((2, 16, cfg.d_model), 14)
    got = XL.apply_slstm(cfg, _group(ps), T(x), time_chunk=time_chunk)
    want = jax.jit(lambda p_, x_: JXL.apply_slstm(cfg_j, p_, x_, time_chunk=time_chunk))(ps, x)
    _close(got, want, atol=1e-4, rtol=1e-4)
    one = XL.apply_slstm(cfg, _group(ps), T(x), time_chunk=1)
    assert torch.equal(got, one)
    with pytest.raises(ValueError):
        XL.apply_slstm(cfg, _group(ps), T(x[:, :15]), time_chunk=time_chunk * 2)


def test_decode_slstm_f32(xlstm):
    cfg_j, cfg, _, ps = xlstm
    B, S = 2, 9
    xs = _x((B, S, cfg.d_model), 15)
    st, jst = XL.slstm_state_init(cfg, B), JXL.slstm_state_init(cfg_j, B)
    tp = _group(ps)
    jstep = jax.jit(lambda p_, x_, s_: JXL.decode_slstm(cfg_j, p_, x_, s_))
    for t in range(S):
        out, st = XL.decode_slstm(cfg, tp, T(xs[:, t:t + 1]), st)
        jout, jst = jstep(ps, xs[:, t:t + 1], jst)
        _close(out, jout, atol=1e-4, rtol=1e-4, what=f"step {t}")
        for k in st:
            _close(st[k], jst[k], atol=1e-4, rtol=1e-4, what=k)
    full = XL.apply_slstm(cfg, tp, T(xs))
    _close(full[:, -1:], out, atol=1e-5)


# ---- the ssm family whole, in bf16 (the hybrid's: test_torch_families.py) ---------------

@pytest.fixture(scope="module")
def fam():
    return tf.Family("xlstm-125m")


@pytest.mark.parametrize("knobs", [{"use_flash": True}, {},
                                   {"use_flash": True, "cast_params_once": True,
                                    "slstm_chunk": 4}],
                         ids=["flash", "dense", "flash_cast_once_chunk4"])
def test_prefill_fn_bf16(fam, knobs):
    tf.check_prefill(fam, knobs)


def test_prefill_fn_ignores_slstm_chunk(fam):
    """The port steps the sLSTM one position at a time whatever
    ``slstm_chunk`` (the reference's steps per scan iteration): 1 and 8 give
    one result, bit for bit."""
    b = tf.torch_batch(tf.batch(fam.cfg, 2, 32, seed=0))
    one, eight = (M.prefill_fn(fam.cfg, fam.pt, b, ShardCtx(slstm_chunk=c)) for c in (1, 8))
    assert torch.equal(one, eight)


def test_decode_fn_steps_bf16(fam):
    tf.check_decode(fam)


def test_loss_fn_bf16(fam):
    tf.check_loss(fam)


def test_engine_greedy_matches_reference(fam):
    tf.check_engine(fam)
