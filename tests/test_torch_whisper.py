"""The port's encoder-decoder (``repro_torch.models.whisper``) and
cross-attention against the JAX package, on the CPU; then the whisper
smoke model whole.

Modules in f32: the encoder, the teacher-forced decoder, the memory K/V and
the decode step cast their inputs to the compute dtype, so these tests set
it to f32 on both sides (``CDTYPE`` of each package's ``whisper`` and
``layers`` modules, patched for the test only). The model in bf16 at the
reference's own tolerance (``torch_families``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as tf
from repro.configs import registry as jreg
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import whisper as JW
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import whisper as W
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax

T = torch.from_numpy
ARCH = "whisper-tiny"
F32_ATOL, F32_RTOL = 2e-5, 1e-5


def _close(got, want, atol=F32_ATOL, rtol=F32_RTOL, what=""):
    np.testing.assert_allclose(tf.np32(got), tf.np32(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("Hkv", [4, 2])
def test_cross_attention_f32(Hkv):
    cfg_j = dataclasses.replace(jreg.get_smoke_config(ARCH), num_kv_heads=Hkv)
    cfg = ModelConfig(**dataclasses.asdict(cfg_j))
    p = jax.tree.map(np.array, JA.attn_params(cfg_j, jax.random.PRNGKey(1)))
    x = _x((2, 7, cfg.d_model), 2, 0.5)
    mk, mv = _x((2, 11, Hkv, cfg.head_dim), 3), _x((2, 11, Hkv, cfg.head_dim), 4)
    tp = torch.nn.ParameterDict({k: L.param(T(v)) for k, v in p.items()})
    # the port's cross_attention takes k/v as projected, [B, T, kv_dim]
    got = A.cross_attention(cfg, tp, T(x), (T(mk).flatten(2), T(mv).flatten(2)))
    _close(got, JA.cross_attention(cfg_j, p, x, (mk, mv)))
    got = A.decode_cross_attention(cfg, tp, T(x[:, :1]), (T(mk), T(mv)))
    _close(got, JA.decode_cross_attention(cfg_j, p, x[:, :1], (mk, mv)))


@pytest.fixture(scope="module")
def smoke():
    cfg_j = jreg.get_smoke_config(ARCH)
    cfg = ModelConfig(**dataclasses.asdict(cfg_j))
    pj = jax.jit(lambda k: JW.init_params(cfg_j, k))(jax.random.PRNGKey(0))
    pj = jax.tree.map(np.asarray, pj)
    # non-zero norm biases and layer-norm gains other than one
    for g in ("enc_norm", "final_norm"):
        pj[g] = {"w": pj[g]["w"] + _x(pj[g]["w"].shape, 5, 0.1),
                 "b": pj[g]["b"] + _x(pj[g]["b"].shape, 6, 0.1)}
    return cfg_j, cfg, pj, params_from_jax(cfg, pj, device="cpu")


@pytest.fixture
def f32(monkeypatch):
    for mod in (JW, JL):
        monkeypatch.setattr(mod, "CDTYPE", jnp.float32)
    for mod in (W, L):
        monkeypatch.setattr(mod, "CDTYPE", torch.float32)


def test_encode_f32(smoke, f32):
    cfg_j, cfg, pj, pt = smoke
    x = _x((2, 24, cfg.d_model), 7, 0.1)
    got = W.encode(cfg, pt, T(x))
    want = jax.jit(lambda p, f: JW.encode(cfg_j, p, f, None))(pj, x)
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [1, 300, 8192, 8193, 20000])
def test_positions_tile_past_the_table(n):
    """Past pos_enc's 8192 rows the reference tiles the table (stub-safe)."""
    table = _x((8192, 8), 14)
    pos = jnp.asarray(table)
    if n > pos.shape[0]:
        pos = jnp.tile(pos, (-(-n // pos.shape[0]), 1))
    np.testing.assert_array_equal(W._positions(T(table), n).float().numpy(),
                                  tf.np32(pos[:n].astype(jnp.bfloat16)))


def test_decode_train_and_loss_f32(smoke, f32):
    cfg_j, cfg, pj, pt = smoke
    mem = _x((2, 20, cfg.d_model), 8)
    toks = tf.tokens(cfg, 2, 12, seed=9)
    got = W.decode_train(cfg, pt, T(toks).long(), T(mem))
    want = jax.jit(lambda p, t, m: JW.decode_train(cfg_j, p, t, m, None))(pj, toks, mem)
    _close(got, want, atol=1e-4, rtol=1e-4)
    batch = {"frames": _x((2, 20, cfg.d_model), 10, 0.1), "tokens": toks,
             "labels": tf.tokens(cfg, 2, 12, seed=11)}
    got = W.seq2seq_loss(cfg, pt, {k: T(v) for k, v in batch.items()})
    want = jax.jit(lambda p, b: JW.seq2seq_loss(cfg_j, p, b))(pj, batch)
    _close(got, want, atol=1e-5)


def test_prefill_memory_and_decode_step_f32(smoke, f32):
    """The memory K/V of 20 frames, then 12 decode steps against it (and
    the step past max_target_len reads the last pos_dec row)."""
    cfg_j, cfg, pj, pt = smoke
    B, T_, steps = 2, 20, 12
    frames = _x((B, T_, cfg.d_model), 12, 0.1)
    mk, mv = W.prefill_memory(cfg, pt, T(frames))
    jmk, jmv = jax.jit(lambda p, f: JW.prefill_memory(cfg_j, p, f))(pj, frames)
    assert mk.shape == jmk.shape == (cfg.num_layers, B, T_, cfg.num_kv_heads, cfg.head_dim)
    _close(mk, jmk, atol=1e-4, rtol=1e-4)
    _close(mv, jmv, atol=1e-4, rtol=1e-4)
    cache = W.init_cache(cfg, B, 16)
    jcache = JW.init_cache(cfg_j, B, 16)
    cache["mem_kv"], jcache["mem_kv"] = (mk, mv), (jmk, jmv)
    toks = tf.tokens(cfg, B, steps, seed=13)
    jstep = jax.jit(lambda p, t, c, pos: JW.decode_step(cfg_j, p, t, c, pos))
    for i in range(steps):
        logits, cache = W.decode_step(cfg, pt, T(toks[:, i:i + 1]).long(), cache, i)
        jlogits, jcache = jstep(pj, toks[:, i:i + 1], jcache, jnp.int32(i))
        _close(logits, jlogits, atol=1e-4, rtol=1e-4, what=f"step {i}")
    _close(cache["self"]["k"], jcache["self"]["k"], atol=1e-4, rtol=1e-4)
    _close(cache["self"]["v"], jcache["self"]["v"], atol=1e-4, rtol=1e-4)
    row = W.decode_step(cfg, pt, T(toks[:, :1]).long(), W.init_cache(cfg, B, 64) | {
        "mem_kv": (mk, mv)}, 40)[0]
    jrow = jstep(pj, toks[:, :1], JW.init_cache(cfg_j, B, 64) | {"mem_kv": (jmk, jmv)},
                 jnp.int32(40))[0]
    _close(row, jrow, atol=1e-4, rtol=1e-4)


def test_init_cache_layout(smoke):
    cfg_j, cfg, _, _ = smoke
    cache = M.init_cache(cfg, 2, 100, device="cpu")
    jcache = jax.eval_shape(lambda: JM.init_cache(cfg_j, 2, 100))
    for name, t, a in tf._pairs(cache, jcache):
        assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16, name


# ---- the encoder-decoder whole, in bf16 ------------------------------------------------

@pytest.fixture(scope="module")
def fam():
    return tf.Family(ARCH)


def test_prefill_fn_bf16(fam):
    tf.check_prefill(fam, {})


def test_decode_fn_steps_bf16(fam):
    tf.check_decode(fam)


def test_loss_fn_bf16(fam):
    tf.check_loss(fam)


def test_engine_greedy_matches_reference(fam):
    tf.check_engine(fam)
