"""The port's MoE (``repro_torch.models.moe``) and the MoE families against
the JAX package, on the CPU.

The module is held in f32, where both sides route alike: the test inputs
keep the reference's routing margin (the k-th and (k+1)-th expert
probabilities of every token apart by far more than f32 rounding, or tied
exactly), and tie on purpose: duplicate token rows tie in each expert's
capacity top-C, zero rows and duplicate router columns tie the router's
top-k. The moonshot and mixtral smoke models are held whole in bf16
(``torch_families``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as tf
from repro.configs import registry as jreg
from repro.models import moe as JMoE
from repro_torch.models import moe as MoE
from repro_torch.models.config import ModelConfig

T = torch.from_numpy
F32_ATOL = 2e-5
ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x22b")


def _cfgs(arch, **kw):
    cfg_j = dataclasses.replace(jreg.get_smoke_config(arch), **kw)
    return cfg_j, ModelConfig(**dataclasses.asdict(cfg_j))


def _params(cfg_j, seed=0):
    return jax.tree.map(np.array, JMoE.moe_params(cfg_j, jax.random.PRNGKey(seed)))


def _dup_router_column(cfg_j, p, x):
    """Copy token 0's k-th expert's router column over its (k+1)-th's: the
    two get equal logits for every token, and token 0 ties at its cut."""
    order = np.argsort(-(x[0] @ p["router"]), kind="stable")
    p["router"] = p["router"].copy()
    p["router"][:, order[cfg_j.top_k]] = p["router"][:, order[cfg_j.top_k - 1]]


def _tokens(cfg, T_, case, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T_, cfg.d_model)).astype(np.float32)
    if case == "dup_rows":      # 6 distinct rows, each repeated: capacity ties
        x = np.repeat(x[: T_ // 4], 4, axis=0)[:T_]
        x = x[np.random.default_rng(seed + 1).permutation(T_)]
    elif case == "zero_rows":   # every expert ties in the router
        x[::5] = 0.0
    return x


def _margins_ok(cfg_j, p, x):
    """The reference's routing margin on these inputs: every token's k-th
    and (k+1)-th probability apart by >= 1e-4 or tied exactly. Also the
    number of exact ties and the tokens routed to each expert."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), axis=-1))
    s = -np.sort(-probs, axis=-1)
    gap = s[:, cfg_j.top_k - 1] - s[:, cfg_j.top_k]
    load = np.bincount(np.asarray(jax.lax.top_k(probs, cfg_j.top_k)[1]).ravel(),
                       minlength=cfg_j.num_experts)
    return bool(((gap == 0) | (gap >= 1e-4)).all()), int((gap == 0).sum()), load


def _ref(cfg_j, p, x):
    return np.asarray(JMoE.moe_ffn_shard(
        cfg_j, jnp.asarray(x), jnp.asarray(p["router"]), jnp.asarray(p["w_gate"][0]),
        jnp.asarray(p["w_up"][0]), jnp.asarray(p["w_down"][0]), jnp.asarray(0, jnp.int32), V=1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case,cf", [("random", None), ("dup_rows", 1.0), ("zero_rows", None),
                                     ("dup_rows", 0.5)])
@pytest.mark.parametrize("dup_cols", [False, True])
def test_moe_ffn_shard_f32(arch, case, cf, dup_cols):
    """f32 against the reference, with ties in both top-k sites; a
    capacity factor of 1.0 or 0.5 makes the capacity cut bind among
    duplicate rows."""
    cfg_j, cfg = _cfgs(arch, **({"capacity_factor": cf} if cf else {}))
    p = _params(cfg_j)
    x = _tokens(cfg, 24, case)
    if dup_cols:
        _dup_router_column(cfg_j, p, x)
    ok, ties, load = _margins_ok(cfg_j, p, x)
    assert ok
    if case == "zero_rows" or dup_cols:
        assert ties > 0
    if cf is not None:   # the capacity cut drops tokens: duplicates tie at it
        assert load.max() > MoE.capacity(cfg, 24)
    got = MoE.moe_ffn_shard(cfg, T(x), T(p["router"]), T(p["w_gate"][0]), T(p["w_up"][0]),
                            T(p["w_down"][0]))
    np.testing.assert_allclose(got.numpy(), _ref(cfg_j, p, x), atol=F32_ATOL, rtol=1e-5)


def test_top_k_orders_ties_as_lax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (64, 33)).astype(np.float32)   # many ties
    x[5] = -np.inf
    for k in (1, 2, 6, 33):
        v, i = MoE.top_k(T(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("T_", [1, 3, 4, 7, 24, 100, 16384])
@pytest.mark.parametrize("arch", ARCHS + ("jamba-v0.1-52b",))
def test_capacity_and_layout(arch, T_):
    cfg = ModelConfig(**dataclasses.asdict(jreg.get_config(arch)))
    E = cfg.num_experts
    assert MoE.capacity(cfg, T_) == min(
        max(int(-(-T_ * cfg.top_k * cfg.capacity_factor // E)), 4), T_)
    for V in (1, 2, 4, 16, 64, 128):
        try:
            want = JMoE.moe_layout(cfg, V)
        except ValueError:
            with pytest.raises(ValueError):
                MoE.moe_layout(cfg, V)
            continue
        assert MoE.moe_layout(cfg, V) == want


def test_moonshot_capacity_at_full_width():
    """B 4 x S 4096 tokens through 64 experts top-6 keep 1,920 per expert."""
    cfg = ModelConfig(**dataclasses.asdict(jreg.get_config("moonshot-v1-16b-a3b")))
    assert MoE.capacity(cfg, 4 * 4096) == 1920


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_f32(arch):
    cfg_j, cfg = _cfgs(arch)
    p = _params(cfg_j, seed=1)
    x = (np.random.default_rng(7).standard_normal((2, 9, cfg.d_model))).astype(np.float32)
    got = MoE.apply_moe(cfg, torch.nn.ParameterDict(
        {k: torch.nn.Parameter(T(v), requires_grad=False) for k, v in p.items()}), T(x))
    want = JMoE.apply_moe(cfg_j, p, jnp.asarray(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_duplicate_rows_equal(arch):
    """bf16: duplicate token rows give equal output rows where the capacity
    cut keeps them alike; the whole output within bf16 rounding of the
    reference's."""
    cfg_j, cfg = _cfgs(arch)
    p = _params(cfg_j, seed=2)
    x = np.repeat(_tokens(cfg, 8, "random", seed=4), 3, axis=0)      # rows 3i..3i+2 equal
    xb = T(x).to(torch.bfloat16)
    w = [T(p[k][0]).to(torch.bfloat16) for k in ("w_gate", "w_up", "w_down")]
    got = MoE.moe_ffn_shard(cfg, xb, T(p["router"]), *w)
    again = MoE.moe_ffn_shard(cfg, xb, T(p["router"]), *w)
    assert torch.equal(got, again)
    g = got.float().numpy().reshape(8, 3, cfg.d_model)
    np.testing.assert_array_equal(g[:, 0], g[:, 1])
    np.testing.assert_array_equal(g[:, 0], g[:, 2])
    want = JMoE.moe_ffn_shard(cfg_j, jnp.asarray(x, jnp.bfloat16), jnp.asarray(p["router"]),
                              *(jnp.asarray(p[k][0]) for k in ("w_gate", "w_up", "w_down")),
                              jnp.asarray(0, jnp.int32), V=1)
    np.testing.assert_allclose(g.reshape(24, -1), tf.np32(want), atol=0.05, rtol=0.05)


# ---- the MoE families whole, in bf16 ---------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return tf.Family(request.param)


@pytest.mark.parametrize("knobs", [{"use_flash": True}, {}, {"use_flash": True,
                                                            "cast_params_once": True}],
                         ids=["flash", "dense", "flash_cast_once"])
def test_prefill_fn_bf16(fam, knobs):
    tf.check_prefill(fam, knobs)


def test_decode_fn_steps_bf16(fam):
    tf.check_decode(fam)


def test_loss_fn_bf16(fam):
    tf.check_loss(fam)


def test_engine_greedy_matches_reference(fam):
    tf.check_engine(fam)
