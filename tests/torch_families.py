"""Shared checks of a model family's whole serving path, port against the
JAX package, on the CPU in bf16 (imported by the ``test_torch_*`` family
files; not collected itself).

The reference's params come across with ``params_from_jax``; inputs are
seeded numpy. XLA's CPU compiler keeps fused bf16 chains in f32 and torch
rounds after each op, so bf16 logits differ by a few ulps: the whole path
is held at the reference's own decode-vs-forward tolerance
(``tests/test_models.py:87``), and greedy tokens up to the reference's
first near-tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.models.sharding import ShardCtx as JShardCtx
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import registry as reg
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.sharding import ShardCtx
from repro_torch.serve.engine import Engine

LOGITS_ATOL, LOGITS_RTOL = 0.15, 0.1


class Family:
    """One arch's smoke config on both sides, with the reference's params
    and the port's copy, and the reference's jitted decode step."""

    def __init__(self, arch: str):
        self.arch = arch
        self.cfg_j = jreg.get_smoke_config(arch)
        self.cfg = reg.get_smoke_config(arch)
        cfg_j = self.cfg_j
        self.pj = jax.jit(lambda k: JM.init_fn(cfg_j, k))(jax.random.PRNGKey(0))
        self.pt = params_from_jax(self.cfg, jax.tree.map(np.asarray, self.pj), device="cpu")
        self.jdecode = jax.jit(lambda p, t, c, pos: JM.decode_fn(cfg_j, p, t, c, pos))
        self.jloss = jax.jit(lambda p, b: JM.loss_fn(cfg_j, p, b))

    def jprefill(self, batch, ctx=None):
        return jax.jit(lambda p, b: JM.prefill_fn(self.cfg_j, p, b, ctx))(self.pj, batch)


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def one_device_ctx(**kw):
    """The reference's ShardCtx on a one-device mesh."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return JShardCtx(mesh=mesh, **kw)


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


def batch(cfg, B, S, seed):
    """numpy batch as the reference's tests make it: tokens, labels, and the
    stub frontends' inputs (frames of S positions with 16 target tokens;
    ``num_patches`` patch embeddings before S text tokens)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        b["patch_embeds"] = (rng.standard_normal((B, cfg.num_patches, cfg.d_model))
                             * 0.02).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
        b["tokens"], b["labels"] = b["tokens"][:, :16], b["labels"][:, :16]
    return b


def jax_batch(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else jnp.int32)
            for k, v in b.items()}


def torch_batch(b, device="cpu"):
    return {k: (torch.from_numpy(v).to(device, torch.bfloat16) if v.dtype == np.float32
                else torch.from_numpy(v).long().to(device)) for k, v in b.items()}


def close(got, want, what=""):
    np.testing.assert_allclose(np32(got), np32(want), atol=LOGITS_ATOL, rtol=LOGITS_RTOL,
                               err_msg=what)


def check_prefill(fam: Family, knobs: dict, B=2, S=32):
    b = batch(fam.cfg, B, S, seed=0)
    got = M.prefill_fn(fam.cfg, fam.pt, torch_batch(b), ShardCtx(**knobs))
    want = fam.jprefill(jax_batch(b), one_device_ctx(**knobs))
    if fam.cfg.is_encoder_decoder:   # the decoder's memory K/V
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.bfloat16
            close(g, w)
        return
    assert got.shape == (B, 1, fam.cfg.vocab_size) and got.dtype == torch.bfloat16
    close(got, want)


def check_loss(fam: Family, B=2, S=32):
    b = batch(fam.cfg, B, S, seed=4)
    got = M.loss_fn(fam.cfg, fam.pt, torch_batch(b))
    want = fam.jloss(fam.pj, jax_batch(b))
    assert got.shape == () and got.dtype == torch.float32
    close(got, want)
    assert 0 < float(got) < 3 * np.log(fam.cfg.vocab_size)


def _caches(fam: Family, B, max_len, seed):
    """Both sides' decode caches; the encoder-decoder's memory K/V from each
    side's own ``prefill_fn`` of the same frames (max_len of them)."""
    cache = M.init_cache(fam.cfg, B, max_len, device="cpu")
    jcache = JM.init_cache(fam.cfg_j, B, max_len)
    if fam.cfg.is_encoder_decoder:
        b = batch(fam.cfg, B, max_len, seed)
        cache["mem_kv"] = M.prefill_fn(fam.cfg, fam.pt, torch_batch(b))
        jcache["mem_kv"] = fam.jprefill(jax_batch(b))
    return cache, jcache


def _pairs(cache, jcache, prefix=""):
    """(name, port tensor, reference array) for every leaf of the caches."""
    if isinstance(jcache, dict):
        for k, v in jcache.items():
            yield from _pairs(cache[k], v, f"{prefix}{k}.")
    elif isinstance(jcache, (tuple, list)):
        for i, v in enumerate(jcache):
            yield from _pairs(cache[i], v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], cache, jcache


def check_decode(fam: Family, B=2, steps=12, max_len=16):
    """decode_fn stepped over 12 tokens: the logits of each step, and every
    leaf of the caches (shape, dtype-class and values) after the last."""
    toks = tokens(fam.cfg, B, steps, seed=1)
    cache, jcache = _caches(fam, B, max_len, seed=5)
    for name, t, a in _pairs(cache, jcache):
        assert tuple(t.shape) == a.shape, name
    for i in range(steps):
        logits, cache = M.decode_fn(fam.cfg, fam.pt, torch.from_numpy(toks[:, i:i + 1]).long(),
                                    cache, i)
        jlogits, jcache = fam.jdecode(fam.pj, jnp.asarray(toks[:, i:i + 1]), jcache,
                                      jnp.int32(i))
        assert logits.shape == (B, 1, fam.cfg.vocab_size)
        close(logits, jlogits, f"step {i}")
    for name, t, a in _pairs(cache, jcache):
        # attention rows and recurrent states: activations of the same bf16
        # layers as the logits, held at their tolerance
        close(t, a, name)


def check_engine(fam: Family, B=3, P=10, steps=8, max_len=32):
    """Greedy tokens equal the reference Engine's: a row may part from the
    reference's only at a step where the reference's own top-1/top-2 logit
    margin is below the logits tolerance (there a few bf16 ulps may pick the
    other token), and is compared up to there.

    Both engines take the argmax of the last prompt step (t0) and feed it
    without returning it, so output i comes from the logits after feeding
    t0 (i = 0) or output i - 1: the margins are taken along that sequence,
    t0's included (a near-tie there may part a row from its first output)."""
    prompts = tokens(fam.cfg, B, P, seed=2)
    got, stats = Engine(fam.cfg, fam.pt, max_len=max_len).generate(prompts, steps)
    want, _ = JEngine(fam.cfg_j, fam.pj, max_len=max_len).generate(prompts, steps)
    assert got.shape == want.shape == (B, steps) and got.dtype == np.int32
    assert stats.tokens == B * steps and stats.decode_s > 0
    jcache = JM.init_cache(fam.cfg_j, B, max_len)
    margins, tok = [], None
    for i in range(P + steps):
        t = prompts[:, i:i + 1] if i < P else (tok if i == P else want[:, i - P - 1:i - P])
        jl, jcache = fam.jdecode(fam.pj, jnp.asarray(t), jcache, jnp.int32(i))
        if i >= P - 1:
            top = np.sort(np32(jl)[:, 0], axis=-1)
            margins.append(top[:, -1] - top[:, -2])
        if i == P - 1:
            tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        elif i >= P:   # the reference's own outputs along its own sequence
            np.testing.assert_array_equal(np.asarray(jnp.argmax(jl[:, -1], axis=-1)),
                                          want[:, i - P])
    margins = np.stack(margins, axis=1)          # [B, 1 + steps]: t0, then each output
    agreed = 0
    for b in range(B):
        for i in range(steps):
            if got[b, i] != want[b, i]:   # only at a near-tie; then the rows part
                assert min(margins[b, 0], margins[b, i + 1]) < LOGITS_ATOL, (b, i, margins[b])
                break
            agreed += 1
    assert agreed >= B, (got, want, margins)
