"""The port's serving path (``repro_torch.models``, ``repro_torch.serve``)
against the JAX package, on the CPU.

The same numpy inputs, and the reference's own ``init_fn`` params carried
across by ``params_from_jax``, go through the JAX function and its port. On
the CPU the port's flash route runs its plain version (``flash_ref``); the
JAX side runs its oracle and, where stated, its Pallas kernel in interpret
mode. Modules are compared in f32, where both sides round alike; the whole
path in bf16, where XLA's CPU compiler keeps fused chains in f32 and torch
rounds after each op, so bf16 logits differ by a few bf16 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as tf
from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flashattn import flash_attention_pallas
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.sharding import ShardCtx as JShardCtx
from repro_torch.configs import registry as reg
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.sharding import ShardCtx
from repro_torch.serve.engine import Engine

T = torch.from_numpy
ARCH = "llama3.2-3b"
F32_ATOL = 2e-5       # f32 on both sides: only the order of the sums differs
# One bf16 rounding of an O(1) output is at most 2^-8 relative; 0.02 covers
# a one-ulp difference up to |x| < 4 (f32 math inside, bf16 out on both sides).
BF16_FLASH_ATOL = 0.02
# Whole-model bf16 logits: every layer rounds in other places on the two
# sides (see the module docstring); the reference's own decode-vs-forward
# test allows atol 0.15, rtol 0.1 at this size.
LOGITS_ATOL, LOGITS_RTOL = 0.15, 0.1


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _group(p: dict) -> torch.nn.ParameterDict:
    return torch.nn.ParameterDict({k: L.param(T(np.array(v, np.float32)))
                                   for k, v in p.items()})


def _one_device_ctx(**kw):
    """The reference's ShardCtx on a one-device mesh."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return JShardCtx(mesh=mesh, **kw)


@pytest.fixture(scope="module")
def smoke():
    """The llama3.2 smoke config, the reference's params, and the port's."""
    cfg_j = jreg.get_smoke_config(ARCH)
    cfg = reg.get_smoke_config(ARCH)
    pj = JM.init_fn(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_jax(cfg, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg, pj, pt


# ---- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_configs_are_the_references(arch):
    for get, jget in ((reg.get_config, jreg.get_config),
                      (reg.get_smoke_config, jreg.get_smoke_config)):
        a, b = get(arch), jget(arch)
        assert isinstance(a, ModelConfig)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert a.layer_kinds() == b.layer_kinds()
    assert reg.SHAPES == tuple(reg.ShapeCell(**dataclasses.asdict(c)) for c in jreg.SHAPES)


# ---- flash attention ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 300])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64),
                                           (True, 128), (False, 64)])
def test_flash_ref_matches_reference_and_pallas(dtype, S, causal, window):
    """The port's plain version against the reference's oracle and against
    the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(S + window + 7 * causal)
    q, k, v = (rng.standard_normal((2, S, 64)).astype(np.float32) for _ in range(3))
    jd = jnp.dtype(dtype)
    tq, tk, tv = (T(x).to(getattr(torch, dtype)) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    got = ref.flash_ref(tq, tk, tv, causal, window)
    assert got.dtype == tq.dtype
    atol = F32_ATOL if dtype == "float32" else BF16_FLASH_ATOL
    want = jref.flash_ref(jq, jk, jv, causal, window)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
    pallas = flash_attention_pallas(jq, jk, jv, causal, window, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=atol, rtol=0)


def test_ops_flash_attention_gqa():
    """GQA expansion: query head h reads KV head h // rep, as ``jnp.repeat``."""
    rng = np.random.default_rng(3)
    B, S, H, Hkv, D = 2, 80, 6, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    got = ops.flash_attention(T(q), T(k), T(v), causal=True, window=24)
    assert got.shape == (B, S, H, D)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, window=24, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,causal,window", [(130, True, 0), (130, True, 24),
                                             (77, False, 16)])
def test_flash_bshd_ref_matches_reference_and_pallas(dtype, S, causal, window):
    """The plain version of the kernel's interface (q [B, S, H, D], k/v
    [B, S, Hkv, D], GQA read in place) against the JAX ``ops.flash_attention``
    on its reference route and on the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(S + window)
    B, H, Hkv, D = 2, 6, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    jd = jnp.dtype(dtype)
    got = ref.flash_bshd_ref(*(T(x).to(getattr(torch, dtype)) for x in (q, k, v)),
                             causal, window)
    assert got.shape == (B, S, H, D) and got.dtype == getattr(torch, dtype)
    atol = F32_ATOL if dtype == "float32" else BF16_FLASH_ATOL
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    for use_pallas in (False, True):
        want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    use_pallas=use_pallas)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _flash_split_p(q, k, v, bk: int = 128):
    """The bf16 kernel's arithmetic in plain torch, one [S, D] slice: online
    softmax over key tiles of ``bk`` with f32 statistics, P split into bf16
    P_hi + P_lo, both products of bf16 operands accumulated in f32, the row
    sum from the f32 P, causal mask. Returns the f32 output and the same
    with P rounded once to bf16."""
    S, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = D ** -0.5
    m = torch.full((S, 1), -torch.inf)
    l = torch.zeros(S, 1)
    acc, acc_once = torch.zeros(S, D), torch.zeros(S, D)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = (qf @ kf[k0:k0 + bk].T) * scale
        s = torch.where(torch.arange(k0, min(S, k0 + bk))[None, :] <= rows, s, -torch.inf)
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        l = alpha * l + p.sum(dim=1, keepdim=True)
        acc = alpha * acc + p_hi @ vf[k0:k0 + bk] + p_lo @ vf[k0:k0 + bk]
        acc_once = alpha * acc_once + p_hi @ vf[k0:k0 + bk]
        m = m_new
    return acc / l, acc_once / l


def test_flash_split_p_holds_the_card_tolerance():
    """CPU evidence for the bf16 kernel's one numerical choice: with P split
    into two bf16 parts, the output stays within chip_smoke.py's bf16 check
    (rtol 2^-7, atol 1e-4) of ``flash_ref`` at S 1024, D 128; the split's
    error before the output's rounding is far below a single rounding's,
    and a single rounding of P would break the check."""
    rng = np.random.default_rng(11)
    q, k, v = (T(rng.standard_normal((2, 1024, 128)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    want = ref.flash_ref(q, k, v, causal=True)
    exact = ref.flash_ref(q.float(), k.float(), v.float(), causal=True)
    for b in range(2):
        split, once = _flash_split_p(q[b], k[b], v[b])
        torch.testing.assert_close(split.to(torch.bfloat16).float(), want[b].float(),
                                   rtol=2.0**-7, atol=1e-4)
        err_split = float((split - exact[b]).abs().max())
        err_once = float((once - exact[b]).abs().max())
        assert err_split * 16 < err_once, (err_split, err_once)
        assert not torch.allclose(once.to(torch.bfloat16).float(), want[b].float(),
                                  rtol=2.0**-7, atol=1e-4)


# ---- layers ---------------------------------------------------------------------

def test_rmsnorm_layernorm_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w, b = rng.standard_normal((2, 48)).astype(np.float32)
    np.testing.assert_allclose(L.rmsnorm(T(x), T(w)).numpy(),
                               np.asarray(JL.rmsnorm(x, w)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(L.layernorm(T(x), T(w), T(b)).numpy(),
                               np.asarray(JL.layernorm(x, w, b)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_f32(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None, :]
    cos, sin = L.rope_angles(T(pos), 16, theta)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 16, theta)
    # angles up to 39 rad: f32 pow/cos/sin of the two libraries differ by ulps
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    np.testing.assert_allclose(L.apply_rope(T(x), cos, sin).numpy(),
                               np.asarray(JL.apply_rope(x, jcos, jsin)), atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_f32(act):
    cfg_j = dataclasses.replace(jreg.get_smoke_config(ARCH), act=act)
    cfg = ModelConfig(**dataclasses.asdict(cfg_j))
    p = jax.tree.map(np.asarray, JL.mlp_params(cfg_j, jax.random.PRNGKey(2)))
    if act == "gelu":   # non-zero biases
        p = {k: (v + 0.1 if k.startswith("b_") else v) for k, v in p.items()}
    x = np.random.default_rng(2).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(L.apply_mlp(cfg, _group(p), T(x)).numpy(),
                               np.asarray(JL.apply_mlp(cfg_j, p, x)), atol=1e-5, rtol=1e-5)


# ---- attention ------------------------------------------------------------------

class _FlashCtx:   # the reference test's mesh-free stand-in (tests/test_flashattn.py)
    use_flash = True
    attn_seq_shard = False


def _attn_case(window: int, bias: bool = False):
    cfg_j = dataclasses.replace(jreg.get_smoke_config(ARCH), sliding_window=window,
                                qkv_bias=bias)
    cfg = ModelConfig(**dataclasses.asdict(cfg_j))
    p = jax.tree.map(np.asarray, JA.attn_params(cfg_j, jax.random.PRNGKey(1)))
    if bias:
        p = {k: (v + 0.05 if k.startswith("b") else v) for k, v in p.items()}
    return cfg_j, cfg, p


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("bf16_attn", [False, True])
def test_self_attention_f32(flash, window, bf16_attn):
    cfg_j, cfg, p = _attn_case(window, bias=window > 0)
    x = (np.random.default_rng(4).standard_normal((2, 37, cfg.d_model)) * 0.5).astype(np.float32)
    got = A.self_attention(cfg, _group(p), T(x), causal=True, bf16=bf16_attn,
                           ctx=ShardCtx(use_flash=True) if flash else None)
    want, (jk, jv) = JA.self_attention(cfg_j, p, x, causal=True, bf16=bf16_attn,
                                       ctx=_FlashCtx() if flash else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=1e-5)
    # the port's self_attention returns no k/v: its projection and RoPE
    # against the reference's returned ones
    _, k, v = A._heads(cfg, *A._project_qkv(cfg, _group(p), T(x)))
    k = L.apply_rope(k, *L.rope_angles(torch.arange(x.shape[1])[None, :], cfg.head_dim,
                                       cfg.rope_theta))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=F32_ATOL, rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=F32_ATOL, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_f32(window):
    """Full cache, and a ring buffer of 5 slots stepped past its length."""
    cfg_j, cfg, p = _attn_case(window)
    B, steps, Smax = 2, 11, 5 if window else 16
    rng = np.random.default_rng(5)
    xs = (rng.standard_normal((steps, B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    shape = (B, Smax, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    jck, jcv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tp = _group(p)
    for pos in range(steps):
        out, ck2, cv2 = A.decode_attention(cfg, tp, T(xs[pos]), ck, cv, pos)
        assert ck2 is ck and cv2 is cv   # written in place
        jout, jck, jcv = JA.decode_attention(cfg_j, p, xs[pos], jck, jcv, jnp.int32(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL, rtol=1e-5)
        np.testing.assert_allclose(ck.numpy(), np.asarray(jck), atol=F32_ATOL, rtol=1e-5)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=F32_ATOL, rtol=1e-5)


# ---- the slice: llama3.2 smoke config in bf16 ---------------------------------------

def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


def test_params_from_jax_is_exact(smoke):
    cfg_j, cfg, pj, pt = smoke
    assert len(pt.blocks) == cfg.num_layers
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(pt.blocks[i]["attn"]["wq"].numpy(),
                                      np.asarray(pj["blocks"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(pt.blocks[i]["mlp"]["w_down"].numpy(),
                                      np.asarray(pj["blocks"]["mlp"]["w_down"][i]))
    np.testing.assert_array_equal(pt.embed["out"].numpy(), np.asarray(pj["embed"]["out"]))
    n = sum(w.numel() for w in pt.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(pj))
    bad = jax.tree.map(np.asarray, pj)
    del bad["blocks"]["mlp"]["w_up"]
    with pytest.raises(KeyError):
        params_from_jax(cfg, bad, device="cpu")


@pytest.mark.parametrize("knobs", [{"use_flash": True}, {"use_flash": False},
                                   {"bf16_attn": True},
                                   {"use_flash": True, "cast_params_once": True}],
                         ids=["flash", "dense", "bf16_attn", "flash_cast_once"])
def test_prefill_fn_bf16(smoke, knobs):
    cfg_j, cfg, pj, pt = smoke
    toks = _tokens(cfg, 2, 40, seed=0)
    got = M.prefill_fn(cfg, pt, {"tokens": T(toks).long()}, ShardCtx(**knobs))
    want = JM.prefill_fn(cfg_j, pj, {"tokens": jnp.asarray(toks)}, _one_device_ctx(**knobs))
    assert got.shape == (2, 1, cfg.vocab_size) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGITS_ATOL, rtol=LOGITS_RTOL)


def test_decode_fn_steps_bf16(smoke):
    """decode_fn stepped over 12 tokens: logits each step and the caches."""
    cfg_j, cfg, pj, pt = smoke
    B, S = 2, 12
    toks = _tokens(cfg, B, S, seed=1)
    cache = M.init_cache(cfg, B, 16, device="cpu")
    jcache = JM.init_cache(cfg_j, B, 16)
    assert cache["k"].shape == jcache["k"].shape and cache["k"].dtype == torch.bfloat16
    for i in range(S):
        logits, cache = M.decode_fn(cfg, pt, T(toks[:, i:i + 1]).long(), cache, i)
        jlogits, jcache = JM.decode_fn(cfg_j, pj, jnp.asarray(toks[:, i:i + 1]), jcache,
                                       jnp.int32(i))
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=LOGITS_ATOL,
                                   rtol=LOGITS_RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), atol=0.05, rtol=0.05)


def test_engine_generate_greedy_matches_reference():
    """Greedy tokens equal the reference's; a row may part from them only at
    a near-tie of the reference's own logits (``torch_families.check_engine``,
    whose margins follow the tokens both engines actually feed)."""
    tf.check_engine(tf.Family(ARCH))


def test_engine_temperature_sampling(smoke):
    cfg_j, cfg, pj, pt = smoke
    prompts = _tokens(cfg, 2, 6, seed=3)
    eng = Engine(cfg, pt, max_len=16)
    a, _ = eng.generate(prompts, 5, temperature=0.8, seed=1)
    b, _ = eng.generate(prompts, 5, temperature=0.8, seed=1)
    assert a.shape == (2, 5) and a.dtype == np.int32
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a, b)   # one seed, one draw


# ---- entry points ------------------------------------------------------------------

def test_one_device_ctx_and_entry_points():
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardCtx(attn_seq_shard=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ShardCtx(mesh=object())
    cfg = reg.get_smoke_config(ARCH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.init_fn(cfg, 0)
    p = M.init_fn(cfg, torch.Generator(device="cpu").manual_seed(0))
    q = M.init_fn(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), q.parameters()))
    assert sum(w.numel() for w in p.parameters()) == sum(
        x.size for x in jax.tree.leaves(jax.eval_shape(
            lambda: JM.init_fn(jreg.get_smoke_config(ARCH), jax.random.PRNGKey(0)))))
