"""Training on the port (``repro_torch.data``, ``repro_torch.train``,
``repro_torch.launch.train``) against the JAX package, on the CPU.

The same numpy inputs go through both packages. Batches, int8 compression
and checkpoints are held bit for bit. Gradients are compared in f32, with
the compute dtype set to float32 on both sides for the test alone
(``monkeypatch`` of each package's ``CDTYPE``; no file changes): there the
two frameworks differ only in the order of their sums. In bf16 they round
at other places, and single leaves of the hybrid differ by up to 26%
(ROADMAP.md, Queue 3), so bf16 is held at the loss, at the tolerance the
port's other loss checks use.
"""
import functools
import importlib
import socket

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypcompat import given, settings, st

from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import registry as reg
from repro_torch.data import pipeline as D
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_jax, to_reference_tree
from repro_torch.models.sharding import ShardCtx
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import Checkpointer, packb
from repro_torch.train.fault_tolerance import (FailureInjector, StepWatchdog,
                                               run_with_restarts)
from repro_torch.train.train_step import (init_train_state, loss_and_grads,
                                          make_train_step, train_state_from_jax)

ARCHS = ("llama3.2-3b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b", "xlstm-125m",
         "whisper-tiny", "internvl2-76b")
LOSS_RTOL_F32 = 1e-5      # f32 on both sides: only the order of the sums differs
LEAF_RTOL_F32 = 1e-4      # relative L2 per leaf (measured at most 1.1e-5: jamba's A_log)
LOGITS_ATOL, LOGITS_RTOL = 0.15, 0.1   # bf16 (tests/test_torch_models.py)
OPT_RTOL = 1e-6           # see test_adamw_update_matches_reference


def _f32(monkeypatch):
    """The compute dtype float32 on both sides (the modules that read it)."""
    for m in ("layers", "attention", "model", "transformer", "whisper"):
        monkeypatch.setattr(importlib.import_module(f"repro.models.{m}"), "CDTYPE",
                            jnp.float32)
    for m in ("layers", "model", "transformer", "whisper"):
        monkeypatch.setattr(importlib.import_module(f"repro_torch.models.{m}"), "CDTYPE",
                            torch.float32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _seq(cfg):
    return cfg.num_patches + 16 if cfg.frontend == "vision_stub" else 16


def _batches(arch, f32):
    """The reference's batch (bf16 inputs in f32 for an f32 run) and the
    port's, of ``DataConfig(seq, 2, seed=1)`` at step 0."""
    cfg_j, cfg = jreg.get_smoke_config(arch), reg.get_smoke_config(arch)
    bj = JD.make_batch(cfg_j, JD.DataConfig(_seq(cfg), 2, seed=1), 0)
    if f32:
        bj = {k: (v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
              for k, v in bj.items()}
    return cfg_j, cfg, bj, D.make_batch(cfg, D.DataConfig(_seq(cfg), 2, seed=1), 0, "cpu")


@functools.lru_cache(maxsize=None)
def _params(arch):
    """Smoke-config params of ``arch`` in the reference's layout (f32
    masters, made once: the compute dtype does not enter them). They are
    drawn by the port's ``init_fn`` and carried across with
    ``to_reference_tree``: jitting the reference's ``init_fn`` would cost
    more than the rest of a test."""
    named = init_train_state(reg.get_smoke_config(arch), 0, "cpu").params.named_parameters()
    return jax.tree.map(jnp.asarray, to_reference_tree(dict(named)))


def _leaf_errors(want: dict, got: dict, path=()):
    """Relative L2 error of every leaf of two nested dicts of arrays."""
    if isinstance(want, dict):
        return [e for k in want for e in _leaf_errors(want[k], got[k], path + (k,))]
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return [(float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)), "/".join(path))]


# --- data ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-tiny", "internvl2-76b"])
def test_make_batch_is_the_references(arch):
    cfg_j, cfg = jreg.get_smoke_config(arch), reg.get_smoke_config(arch)
    for seed, step in ((0, 0), (3, 7)):
        want = JD.make_batch(cfg_j, JD.DataConfig(_seq(cfg), 4, seed=seed), step)
        got = D.make_batch(cfg, D.DataConfig(_seq(cfg), 4, seed=seed), step, "cpu")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.int32)
            assert w.dtype in (jnp.bfloat16, jnp.int32)
            assert g.shape == w.shape
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 else g.numpy(),
                np.asarray(w).view(np.int16) if w.dtype == jnp.bfloat16 else np.asarray(w))
    other = D.make_batch(cfg, D.DataConfig(_seq(cfg), 4, seed=3), 8, "cpu")
    assert not torch.equal(other["tokens"], got["tokens"])


def test_host_shard_is_the_references():
    cfg_j, cfg = jreg.get_smoke_config("llama3.2-3b"), reg.get_smoke_config("llama3.2-3b")
    want = JD.make_batch(cfg_j, JD.DataConfig(8, 8, seed=0), 0)
    got = D.make_batch(cfg, D.DataConfig(8, 8, seed=0), 0, "cpu")
    for i in range(4):
        w, g = JD.host_shard(want, i, 4), D.host_shard(got, i, 4)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    stacked = torch.cat([D.host_shard(got, i, 4)["tokens"] for i in range(4)])
    assert torch.equal(stacked, got["tokens"])


# --- optimizer ----------------------------------------------------------------

def test_adamw_update_matches_reference():
    """Two AdamW steps on the same grads, params and state. The elementwise
    update rounds as the reference's; the global norm adds a 2-D leaf's
    squares in another order than XLA (optimizer.py's docstring), which may
    move ``grad_norm`` and, under the clip, every value by an ulp: hence
    rtol 1e-6 rather than equality."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 256), "b": (5000,), "c": (4, 8, 16)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg_o = O.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = JO.init_opt_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = O.init_opt_state(tp)
    for step in range(2):
        scale = (0.01, 1.0)[step]   # under and over the clip
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jst, jm = JO.adamw_update(jcfg, {k: jnp.asarray(v) for k, v in grads.items()},
                                      jst, jp)
        tp, tst, tm = O.adamw_update(cfg_o, {k: torch.from_numpy(v) for k, v in grads.items()},
                                     tst, tp)
        np.testing.assert_array_equal(_np(tm["lr"]), np.asarray(jm["lr"]))
        np.testing.assert_allclose(_np(tm["grad_norm"]), np.asarray(jm["grad_norm"]),
                                   rtol=OPT_RTOL)
        np.testing.assert_allclose(
            _np(O.global_norm({k: torch.from_numpy(v) for k, v in grads.items()})),
            np.asarray(JO.global_norm({k: jnp.asarray(v) for k, v in grads.items()})),
            rtol=OPT_RTOL)
        assert int(tst.step) == int(jst.step) == step + 1
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (tst.mu[k], jst.mu[k]), (tst.nu[k], jst.nu[k])):
                np.testing.assert_allclose(_np(got), np.asarray(want), rtol=OPT_RTOL,
                                           atol=0, err_msg=k)


def test_schedule_is_the_references():
    cfg = O.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    jcfg = JO.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    steps = list(range(0, 10_001, 37))
    want = np.asarray(jax.vmap(lambda s: JO._schedule(jcfg, s))(
        jnp.asarray(steps, jnp.float32)))
    got = np.array([O._schedule(cfg, s) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)


# --- gradients ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_f32_matches_reference(arch, monkeypatch):
    _f32(monkeypatch)
    cfg_j, cfg, bj, bt = _batches(arch, f32=True)
    pj = _params(arch)
    lj, gj = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(cfg_j, p, b)))(pj, bj)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, pj), device="cpu")
    for w in model.parameters():
        w.requires_grad_(True)
    lt, gt = loss_and_grads(cfg, model, bt)
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL_F32)
    errs = _leaf_errors(jax.tree.map(np.asarray, gj), to_reference_tree(gt))
    worst = max(errs)
    assert worst[0] < LEAF_RTOL_F32, worst
    if arch == "xlstm-125m":   # unused params get zeros, as JAX gives
        assert not gt["layer0.norm2.w"].any() and not np.asarray(gj["layer0"]["norm2"]["w"]).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_bf16_matches_reference(arch):
    cfg_j, cfg, bj, bt = _batches(arch, f32=False)
    pj = _params(arch)
    want = jax.jit(lambda p, b: JM.loss_fn(cfg_j, p, b))(pj, bj)
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, pj), device="cpu")
    _, metrics = make_train_step(cfg, O.AdamWConfig())(state, bt)
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    np.testing.assert_allclose(float(metrics["loss"]), float(want), atol=LOGITS_ATOL,
                               rtol=LOGITS_RTOL)


def test_train_step_f32_matches_reference(monkeypatch):
    """One AdamW step from the reference's own state, both in f32."""
    _f32(monkeypatch)
    cfg_j, cfg, bj, bt = _batches("llama3.2-3b", f32=True)
    pj = _params("llama3.2-3b")
    jstate = JO.init_opt_state(pj)
    from repro.train.train_step import TrainState as JTrainState
    opt_j = JO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    new_j, mj = jax.jit(jmake_train_step(cfg_j, opt_j))(JTrainState(pj, jstate), bj)
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, pj), jstate, device="cpu")
    new_t, mt = make_train_step(cfg, O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8))(
        state, bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=LOSS_RTOL_F32)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-4)
    assert int(new_t.opt.step) == int(new_j.opt.step) == 1
    for want, got in ((new_j.params, dict(new_t.params.named_parameters())),
                      (new_j.opt.mu, new_t.opt.mu), (new_j.opt.nu, new_t.opt.nu)):
        worst = max(_leaf_errors(jax.tree.map(np.asarray, want), to_reference_tree(got)))
        assert worst[0] < LEAF_RTOL_F32, worst


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-tiny", "jamba-v0.1-52b"])
def test_remat_modes_give_the_same_gradients(arch):
    cfg = reg.get_smoke_config(arch)
    model = init_train_state(cfg, 0, "cpu").params
    batch = D.make_batch(cfg, D.DataConfig(_seq(cfg), 2, seed=2), 0, "cpu")
    runs = {mode: loss_and_grads(cfg, model, batch, ShardCtx(remat=mode))
            for mode in ("full", "dots", "none")}
    loss0, g0 = runs["full"]
    for mode, (loss, g) in runs.items():
        assert torch.equal(loss, loss0), mode
        for k in g0:
            assert torch.equal(g[k], g0[k]), (mode, k)
    with pytest.raises(ValueError):
        ShardCtx(remat="all")


# --- checkpoints -------------------------------------------------------------

CFG = reg.get_smoke_config("llama3.2-3b")


def test_checkpoint_restart_bitwise(tmp_path):
    """Training S steps straight == training with a crash + restore at S/2."""
    dc = D.DataConfig(seq_len=16, global_batch=4, seed=1)
    step_fn = make_train_step(CFG, O.AdamWConfig(lr=1e-3, total_steps=8, warmup_steps=1))

    def run(steps, state):
        for s in steps:
            state, _ = step_fn(state, D.make_batch(CFG, dc, s, "cpu"))
        return state

    straight = run(range(6), init_train_state(CFG, 0, "cpu"))
    ck = Checkpointer(str(tmp_path / "ck"))
    state = run(range(3), init_train_state(CFG, 0, "cpu"))
    ck.save(3, {"params": state.params, "opt": state.opt}, blocking=True)
    template = init_train_state(CFG, 5, "cpu")   # another init: all of it is overwritten
    restored = ck.restore(3, {"params": template.params, "opt": template.opt})
    state = run(range(3, 6), template._replace(params=restored["params"], opt=restored["opt"]))
    assert int(state.opt.step) == int(straight.opt.step) == 6
    for (k, a), b in zip(straight.params.named_parameters(), state.params.parameters()):
        assert torch.equal(a, b), k
    for k in straight.opt.mu:
        assert torch.equal(straight.opt.mu[k], state.opt.mu[k]), k
        assert torch.equal(straight.opt.nu[k], state.opt.nu[k]), k


def test_checkpointer_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = init_train_state(CFG, 0, "cpu")
    for s in (1, 2, 3):
        ck.save(s, {"params": state.params})
    ck.wait()
    assert ck.all_steps() == [2, 3]
    assert ck.latest_step() == 3
    assert Checkpointer(str(tmp_path / "empty")).latest_step() is None


def test_checkpoint_is_the_references_format(tmp_path):
    """The same state saved by both packages: the same npz keys and arrays;
    each package restores the other's checkpoint."""
    cfg_j = jreg.get_smoke_config("llama3.2-3b")
    cfg = reg.get_smoke_config("llama3.2-3b")
    pj = _params("llama3.2-3b")
    oj = JO.init_opt_state(pj)
    oj = oj._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree.map(lambda p: p * 0.5, pj),
                     nu=jax.tree.map(lambda p: p * p, pj))
    JCheckpointer(str(tmp_path / "j")).save(7, {"params": pj, "opt": oj}, blocking=True)
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, pj), oj, device="cpu")
    Checkpointer(str(tmp_path / "t")).save(7, {"params": state.params, "opt": state.opt},
                                           meta={"arch": cfg.name}, blocking=True)
    want = np.load(tmp_path / "j" / "ckpt_00000007.npz")
    got = np.load(tmp_path / "t" / "ckpt_00000007.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port restores the reference's checkpoint, and the other way round
    fresh = init_train_state(cfg, 1, "cpu")
    back = Checkpointer(str(tmp_path / "j")).restore(7, {"params": fresh.params,
                                                          "opt": fresh.opt})
    for (k, a), b in zip(state.params.named_parameters(), back["params"].parameters()):
        assert torch.equal(a, b), k
    assert int(back["opt"].step) == 7
    jback = JCheckpointer(str(tmp_path / "t")).restore(7, {"params": pj, "opt": oj})
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves({"params": pj, "opt": oj})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_manifest_bytes_are_msgpacks(tmp_path):
    state = init_train_state(CFG, 0, "cpu")
    ck = Checkpointer(str(tmp_path))
    ck.save(12, {"params": state.params}, meta={"arch": CFG.name}, blocking=True)
    raw = (tmp_path / "ckpt_00000012.manifest").read_bytes()
    man = msgpack.unpackb(raw)
    assert man["step"] == 12 and man["arch"] == CFG.name
    assert raw == msgpack.packb(man)
    cases = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
             -2**63, 0.0, -1.5, 1e300, float("inf"), "", "x" * 31, "x" * 32, "y" * 255,
             "y" * 256, "z" * 65536, "é✓", list(range(15)), list(range(16)),
             list(range(70000)), (1, "a"), {str(i): i for i in range(15)},
             {str(i): i for i in range(16)}, {str(i): [i] for i in range(70000)},
             {"keys": ["a::b/c"] * 40, "time": 1.7e9, "nested": {"ok": [None, 1.25]}}]
    for obj in cases:
        assert packb(obj) == msgpack.packb(obj), repr(obj)[:60]


# --- compression -------------------------------------------------------------

@given(st.integers(0, 1000), st.integers(1, 5000))
@settings(max_examples=10, deadline=None)
def test_quantize_and_feedback_are_the_references(seed, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(np.float32)
    r = (rng.standard_normal(n) * 0.01).astype(np.float32)
    qj, sj = JC.quantize_int8(jnp.asarray(x))
    qt, s_t = C.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(C.dequantize_int8(qt, s_t, (n,)).numpy(),
                                  np.asarray(JC.dequantize_int8(qj, sj, (n,))))
    (qj, sj), rj = JC.compress_with_feedback(jnp.asarray(x), jnp.asarray(r))
    (qt, s_t), rt = C.compress_with_feedback(torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_compression_state_is_the_references():
    """f32 zero residuals over the gradients' tree, leaf for leaf."""
    rng = np.random.default_rng(3)
    grads = {"blocks": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                        "b": rng.standard_normal(7).astype(np.float32)},
             "embed": [rng.standard_normal((4, 2)).astype(np.float32)]}
    ref = JC.init_compression_state(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if a.ndim == 2 else jnp.float32), grads))
    got = C.init_compression_state(jax.tree.map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16 if a.ndim == 2 else torch.float32),
        grads))
    assert isinstance(got, C.CompressionState) and got._fields == ref._fields
    ref_leaves, ref_def = jax.tree.flatten(ref.residual)
    got_leaves, got_def = jax.tree.flatten(got.residual)
    assert got_def == ref_def
    for r, g in zip(ref_leaves, got_leaves):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_error_feedback_telescopes():
    """Sum of dequantized payloads + final residual == sum of raw grads."""
    rng = np.random.default_rng(0)
    g_total = np.zeros(1000, np.float32)
    sent_total = np.zeros(1000, np.float32)
    residual = torch.zeros(1000)
    for _ in range(20):
        g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        g_total += g.numpy()
        (q, s), residual = C.compress_with_feedback(g, residual)
        sent_total += C.dequantize_int8(q, s, g.shape).numpy()
    np.testing.assert_allclose(sent_total + residual.numpy(), g_total, atol=1e-3)


def test_compressed_psum_is_the_references():
    """Four simulated pods: the port's reduction of the stacked values is the
    reference's ``vmap`` over a named axis, bit for bit."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal((4, 3000)).astype(np.float32)
    res = (rng.standard_normal((4, 3000)) * 0.01).astype(np.float32)
    out_j, res_j = jax.vmap(lambda gi, ri: JC.compressed_psum(gi, ri, "pods"),
                            axis_name="pods")(jnp.asarray(g), jnp.asarray(res))
    out_t, res_t = C.reduce_compressed(torch.from_numpy(g), torch.from_numpy(res))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    np.testing.assert_allclose(out_t[0].numpy(), g.mean(0), atol=0.05)


def test_compressed_psum_over_a_process_group():
    """World size 1: no group and a one-process gloo group give the
    reference's one-pod result."""
    import torch.distributed as dist
    rng = np.random.default_rng(2)
    g = rng.standard_normal(2500).astype(np.float32)
    r = (rng.standard_normal(2500) * 0.01).astype(np.float32)
    want = jax.vmap(lambda gi, ri: JC.compressed_psum(gi, ri, "pods"),
                    axis_name="pods")(jnp.asarray(g[None]), jnp.asarray(r[None]))
    got = [C.compressed_psum(torch.from_numpy(g), torch.from_numpy(r))]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        got.append(C.compressed_psum(torch.from_numpy(g), torch.from_numpy(r)))
    finally:
        dist.destroy_process_group()
    for out, res in got:
        np.testing.assert_array_equal(out.numpy(), np.asarray(want[0][0]))
        np.testing.assert_array_equal(res.numpy(), np.asarray(want[1][0]))


# --- fault tolerance and the driver ------------------------------------------

def test_failure_injection_and_restart():
    calls = []
    inj = FailureInjector(fail_at_steps=(2,))

    def run(start):
        calls.append(start)
        for s in range(0 if start != -1 else 2, 5):
            inj.check(s)
        return 5

    assert run_with_restarts(run, max_restarts=2) == 5
    assert calls == [0, -1]  # one failure, one resume
    assert inj.fired == {2}


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0)
    for s in range(10):
        assert not wd.observe(s, 1.0)
    assert wd.observe(10, 10.0)
    assert wd.straggler_steps == [10]


def test_driver_resumes_after_a_failure(tmp_path, capsys):
    out = launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "12",
                             "--fail-at", "5", "--checkpoint-every", "2", "--batch", "4",
                             "--seq", "32", "--device", "cpu", "--log-every", "1",
                             "--checkpoint-dir", str(tmp_path / "run")])
    log = capsys.readouterr().out
    assert out["restarts"] == 1 and log.count("[restart #") == 1
    assert "[restore] resumed from step 4" in log and "[done] final loss" in log
    assert out["final_loss"] < out["first_loss"]
    assert Checkpointer(str(tmp_path / "run")).latest_step() == 12
    for bad, size in ((["--mesh", "pod1"], 256),
                      (["--mesh", "pod2", "--device-order", "sharedmap"], 512)):
        with pytest.raises(RuntimeError, match=f"world size {size}; none is initialized"):
            launch_train.main(["--smoke", "--device", "cpu"] + bad)
