"""MoE expert parallelism (``repro_torch.models.moe`` at V > 1) and one
sharded train step on a real multi-rank world, on the CPU.

* ``moe_ffn_shard`` of each virtual shard ``virt`` of V against the
  reference's, in f32: V = 2 and 4 over 8 experts (each shard owns whole
  experts), and V = 16 over 8 (each expert split into two d_ff shards).
* The V shards' partial outputs, summed in shard order, against V = 1 on the
  same weights laid out whole, at a capacity factor of E / top_k (every
  token kept, so the shards see what the whole layer sees).
* A 2 x 2 gloo world (four CPU processes, ``data`` x ``model``): the MoE
  layer under a mesh ctx, its expert weights ZeRO-sharded over ``data`` by
  ``launch/shardings.py`` (gathered whole, partial outputs summed over
  ``model``) against the one-device port on each data shard's tokens, its
  output and the gradients of its input and weights; one f32 train step of
  the llama smoke config with DTensor params (``make_train_step``, AdamW at
  lr 1e-3) held both against the one-device port and against the JAX
  package's own step on a (2, 2) mesh of four forced host devices (run
  beside the world, from the same params and batch): loss within rtol
  1e-5, every gradient and updated param leaf within relative L2 1e-5; a
  checkpoint of the sharded state restored into a plain one under the same
  shardings, bit for bit; and two decode steps with one kv head, which
  does not divide the model axis, so the KV cache is sharded over its
  sequence: the new rows land in the cache (pos 5 in the first model
  shard's slice, 12 in the second's), the rest stays, and cache and logits
  match the reference's sharded decode.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as JMoE
from repro_torch.models import moe as MoE
from repro_torch.models.config import ModelConfig

T = torch.from_numpy
ARCH = "moonshot-v1-16b-a3b"       # smoke: 8 experts, top-2
SHARD_RTOL, SHARD_ATOL = 1e-6, 1e-6   # a few f32 ulps of O(1) outputs: bmm vs einsum order
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6   # another order of the same f32 sums
LOSS_RTOL, GRAD_RL2 = 1e-5, 1e-5
DECODE_RTOL, DECODE_ATOL = 1e-5, 1e-5   # f32 logits and cache rows: another order of sums
REPO = Path(__file__).resolve().parents[1]


def _cfgs(**kw):
    cfg_j = dataclasses.replace(jreg.get_smoke_config(ARCH), **kw)
    return cfg_j, ModelConfig(**dataclasses.asdict(cfg_j))


def _params(cfg_j, V, seed=0):
    return jax.tree.map(np.array, JMoE.moe_params(cfg_j, jax.random.PRNGKey(seed), V=V))


def _x(cfg, n=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, cfg.d_model)).astype(np.float32)


def _shard(cfg, p, x, virt, V):
    return MoE.moe_ffn_shard(cfg, T(x), T(p["router"]), T(p["w_gate"][virt]),
                             T(p["w_up"][virt]), T(p["w_down"][virt]), virt, V).numpy()


@pytest.mark.parametrize("V", [2, 4, 16])
def test_moe_ffn_shard_per_virt_matches_reference(V):
    cfg_j, cfg = _cfgs()
    p = _params(cfg_j, V)
    x = _x(cfg)
    E_loc, F_v = MoE.moe_layout(cfg, V)
    assert p["w_gate"].shape == (V, E_loc, cfg.d_model, F_v)
    ref = jax.jit(lambda *a: JMoE.moe_ffn_shard(cfg_j, *a, V=V))   # one compile per V
    for virt in range(V):
        got = _shard(cfg, p, x, virt, V)
        want = np.asarray(ref(jnp.asarray(x), jnp.asarray(p["router"]),
                              jnp.asarray(p["w_gate"][virt]), jnp.asarray(p["w_up"][virt]),
                              jnp.asarray(p["w_down"][virt]), jnp.asarray(virt, jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=SHARD_RTOL, atol=SHARD_ATOL)
        # the experts a shard owns, as the reference's
        np.testing.assert_array_equal(
            MoE._phys_expert_ids(cfg, V, virt).numpy(),
            np.asarray(JMoE._phys_expert_ids(cfg_j, V, jnp.asarray(virt, jnp.int32))))


def _whole(cfg, p, V):
    """The V shards' weights laid out for V = 1: shard v's experts are
    experts v * E_loc .. (E >= V); expert e's d_ff shards are virtual shards
    e * V/E .. in order (E < V)."""
    E = cfg.num_experts
    if E >= V:
        return {k: p[k].reshape((1, E) + p[k].shape[2:]) for k in ("w_gate", "w_up", "w_down")}
    r = V // E
    gate = np.concatenate([p["w_gate"][j::r, 0] for j in range(r)], axis=-1)
    up = np.concatenate([p["w_up"][j::r, 0] for j in range(r)], axis=-1)
    down = np.concatenate([p["w_down"][j::r, 0] for j in range(r)], axis=-2)
    return {"w_gate": gate[None], "w_up": up[None], "w_down": down[None]}


@pytest.mark.parametrize("V", [2, 4, 16])
def test_shards_sum_to_the_whole_layer(V):
    cfg_j, cfg = _cfgs()
    cfg_j, cfg = _cfgs(capacity_factor=cfg.num_experts / cfg.top_k)
    p = _params(cfg_j, V, seed=1)
    x = _x(cfg, seed=1)
    assert MoE.capacity(cfg, len(x)) == len(x)     # nothing is dropped
    total = np.zeros_like(x)
    for virt in range(V):
        total = total + _shard(cfg, p, x, virt, V)
    w = _whole(cfg, p, V)
    one = MoE.moe_ffn_shard(cfg, T(x), T(p["router"]), T(w["w_gate"][0]), T(w["w_up"][0]),
                            T(w["w_down"][0])).numpy()
    np.testing.assert_allclose(total, one, rtol=SUM_RTOL, atol=SUM_ATOL)


# ---- a real 2 x 2 world ------------------------------------------------------------

WORKER = r'''
import dataclasses, importlib, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

rank, port = int(sys.argv[1]), int(sys.argv[2])
OPT, DECODE_POS = {OPT!r}, {DECODE_POS!r}
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=4)
torch.manual_seed(0)
for m in ("layers", "model", "transformer", "whisper"):
    setattr(importlib.import_module(f"repro_torch.models.{m}"), "CDTYPE", torch.float32)
from repro_torch.configs import registry as reg
from repro_torch.launch import shardings as SH
from repro_torch.models import model as M, moe as MoE
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx, on_mesh
from repro_torch.train.train_step import init_train_state, loss_and_grads, make_train_step
from repro_torch.train.optimizer import AdamWConfig

mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
ctx = ShardCtx(mesh=mesh)
out = {}

# the MoE layer at V = 2 (the model axis), weights ZeRO-sharded over data
cfg = reg.get_smoke_config("moonshot-v1-16b-a3b")
cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
g = torch.Generator().manual_seed(0)
p = MoE.moe_params(cfg, g, V=2)
x = torch.randn(4, 6, cfg.d_model, generator=g)
with torch.no_grad():
    pd = {k: SH.distribute(w.detach(), SH.leaf_spec("blocks.0.moe." + k, w.dim()), mesh)
          for k, w in p.items()}
    xd = SH.distribute(x, ("data", None, None), mesh)
assert pd["w_gate"].to_local().shape[2] == cfg.d_model // 2     # ZeRO shards over data
leaves = [xd] + [pd[k] for k in ("router", "w_gate", "w_up", "w_down")]
for t in leaves:
    t.requires_grad_(True)
with on_mesh(ctx):
    y = MoE.apply_moe(cfg, pd, xd, ctx)
    l = y.square().sum()
    l = l.redistribute(mesh, [Replicate(), Replicate()])
    grads = torch.autograd.grad(l, leaves)
out["moe"] = y.full_tensor().detach().numpy().tolist()
out["moe_grads"] = [g.redistribute(mesh, t.placements).full_tensor().numpy().tolist()
                    for g, t in zip(grads, leaves)]

# one f32 train step of the llama smoke config
cfg = reg.get_smoke_config("llama3.2-3b")
state = init_train_state(cfg, 0, "cpu")
state = SH.shard_state(state, mesh)
rng = np.random.default_rng(0)
tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
batch = {"tokens": tok, "labels": lab}
batch = SH.place_tree(batch, SH.batch_specs(cfg, batch, ctx), mesh)
loss, grads = loss_and_grads(cfg, state.params, batch, ctx)
out["loss"] = float(loss.full_tensor())
out["grads"] = {k: v.full_tensor().numpy().tolist() for k, v in grads.items()}
state, met = make_train_step(cfg, AdamWConfig(**OPT), ctx)(state, batch)
out["step_loss"] = float(met["loss"].full_tensor())
out["grad_norm"] = float(met["grad_norm"].full_tensor())
out["params"] = {k: w.full_tensor().detach().numpy().tolist()
                 for k, w in state.params.named_parameters()}

# decode with one kv head: it does not divide the model axis, so
# cache_specs shards the cache over its sequence; pos 5 writes into the
# first model shard's slice, 12 into the second's
dcfg = dataclasses.replace(cfg, num_kv_heads=1)
dparams = SH.shard_params(M.init_fn(dcfg, 0, "cpu"), mesh)
cache = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[3]).items()}
cache = SH.place_tree(cache, SH.cache_specs(dcfg, cache, ctx), mesh)
assert all(t.placements[mesh.mesh_dim_names.index("model")] == Shard(2) for t in cache.values())
dtok = {"tokens": torch.arange(4, dtype=torch.int32)[:, None]}
dtok = SH.place_tree(dtok, SH.batch_specs(dcfg, dtok, ctx), mesh)["tokens"]
out["decode"] = [M.decode_fn(dcfg, dparams, dtok, cache, pos, ctx)[0].full_tensor().tolist()
                 for pos in DECODE_POS]
out["cache"] = {k: t.full_tensor().tolist() for k, t in cache.items()}

# a checkpoint of the sharded state, restored into a plain one under the
# same shardings (every rank gathers and writes its own copy)
import tempfile
from repro_torch.train.checkpoint import Checkpointer
ck = Checkpointer(tempfile.mkdtemp())
ck.save(1, {"params": state.params, "opt": state.opt}, blocking=True)
fresh = init_train_state(cfg, 7, "cpu")
place = SH.param_shardings(fresh.params, mesh)
back = ck.restore(1, {"params": fresh.params, "opt": fresh.opt},
                  shardings={"params": place, "opt": place})
same = all(tuple(b.placements) == tuple(a.placements) and torch.equal(a.full_tensor(),
                                                                      b.full_tensor())
           for (_, a), (_, b) in zip(state.params.named_parameters(),
                                     back["params"].named_parameters()))
same = same and all(torch.equal(state.opt.nu[k].full_tensor(), back["opt"].nu[k].full_tensor())
                    for k in state.opt.nu) and int(back["opt"].step) == int(state.opt.step)
out["restored"] = bool(same)
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
'''


# the JAX package's own step and decode on a (2, 2) mesh of four forced
# host devices, from the same params, batch and cache
REFERENCE = r"""
import dataclasses, importlib, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
for m in ("layers", "attention", "model", "transformer", "whisper"):
    setattr(importlib.import_module(f"repro.models.{m}"), "CDTYPE", jnp.float32)
from repro.configs import registry as jreg
from repro.launch import shardings as JSH
from repro.models import model as JM
from repro.models.sharding import ShardCtx
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.train_step import TrainState, make_train_step
from repro_torch.configs import registry as reg
from repro_torch.models import model as M
from repro_torch.models.convert import to_reference_tree
from repro_torch.train.train_step import init_train_state

OPT, DECODE_POS = {OPT!r}, {DECODE_POS!r}
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
ctx = ShardCtx(mesh=mesh)
def place(tree, specs):
    return jax.tree.map(lambda x, s: jax.device_put(
        x, NamedSharding(mesh, JSH.sanitize_spec(s, x.shape, mesh))), tree, specs)
def host(tree):
    return jax.tree.map(lambda a: np.asarray(a).tolist(), tree)
out = {}

cfg = jreg.get_smoke_config("llama3.2-3b")
named = dict(init_train_state(reg.get_smoke_config("llama3.2-3b"), 0, "cpu")
             .params.named_parameters())
params = jax.tree.map(jnp.asarray, to_reference_tree(named))
params = place(params, JSH.param_specs(params))
rng = np.random.default_rng(0)
batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}
batch = place(batch, JSH.batch_specs(cfg, batch, ctx))
loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(cfg, p, b, ctx)))(params, batch)
out["loss"], out["grads"] = float(loss), host(grads)
state, met = jax.jit(make_train_step(cfg, AdamWConfig(**OPT), ctx))(
    TrainState(params, init_opt_state(params)), batch)
out["step_loss"], out["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
out["params"] = host(state.params)

dcfg = dataclasses.replace(cfg, num_kv_heads=1)
dnamed = dict(M.init_fn(dataclasses.replace(reg.get_smoke_config("llama3.2-3b"),
                                             num_kv_heads=1), 0, "cpu").named_parameters())
dparams = jax.tree.map(jnp.asarray, to_reference_tree(dnamed))
dparams = place(dparams, JSH.param_specs(dparams))
cache = dict(np.load(sys.argv[1]))
cache = place(cache, JSH.cache_specs(dcfg, cache, ctx))
tok = place({"tokens": np.arange(4, dtype=np.int32)[:, None]},
            {"tokens": P("data", None)})["tokens"]
step = jax.jit(lambda p, t, c, pos: JM.decode_fn(dcfg, p, t, c, pos, ctx))
out["decode"] = []
for pos in DECODE_POS:
    logits, cache = step(dparams, tok, cache, jnp.asarray(pos, jnp.int32))
    out["decode"].append(np.asarray(logits).tolist())
out["cache"] = host(cache)
print(json.dumps(out))
"""
OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 8}
DECODE_POS = (5, 12)


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text.replace("{OPT!r}", repr(OPT)).replace("{DECODE_POS!r}",
                                                                repr(DECODE_POS)))
    return str(path)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], path + (k,)).items()}
    return {"/".join(path): tree}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_by_two_gloo_world_matches_one_device(monkeypatch, tmp_path):
    import json

    from repro_torch.configs import registry as reg
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference_tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, loss_and_grads, make_train_step

    # the decode cache: random rows everywhere (the mask hides those past pos)
    dcfg = dataclasses.replace(reg.get_smoke_config("llama3.2-3b"), num_kv_heads=1)
    shape = M.init_cache(dcfg, 4, 16, device="cpu")["k"].shape
    rng = np.random.default_rng(1)
    cache0 = {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}
    cache_file = tmp_path / "cache.npz"
    np.savez(cache_file, **cache0)

    worker = _script(tmp_path, "worker.py", WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(port), str(cache_file)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, _script(tmp_path, "reference.py", REFERENCE), str(cache_file)],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    ref = json.loads(outs[-1][0].strip().splitlines()[-1])

    for m in ("layers", "model", "transformer", "whisper"):
        monkeypatch.setattr(__import__(f"repro_torch.models.{m}", fromlist=["x"]), "CDTYPE",
                            torch.float32)
    # the MoE layer: per data shard (2 batch rows), the two model shards' sum
    cfg = reg.get_smoke_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    g = torch.Generator().manual_seed(0)
    p = MoE.moe_params(cfg, g, V=2)
    x = torch.randn(4, 6, cfg.d_model, generator=g)
    leaves = [x] + [p[k] for k in ("router", "w_gate", "w_up", "w_down")]
    for t in leaves:
        t.requires_grad_(True)
    want = torch.cat([sum(MoE.moe_ffn_shard(
        cfg, x[b:b + 2].reshape(-1, cfg.d_model), p["router"], p["w_gate"][v],
        p["w_up"][v], p["w_down"][v], v, 2) for v in range(2)).reshape(2, 6, -1)
        for b in (0, 2)])
    grads = torch.autograd.grad(want.square().sum(), leaves)
    np.testing.assert_allclose(np.array(got["moe"]), want.detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    # the gradients: the gather over data reduce-scatters them, the model sum passes them on
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"), got["moe_grads"], grads):
        assert _rel_l2(a, b.numpy()) <= GRAD_RL2, name

    # the train step, against the one-device port
    cfg = reg.get_smoke_config("llama3.2-3b")
    state = init_train_state(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
    batch = {"tokens": tok, "labels": lab}
    loss, grads = loss_and_grads(cfg, state.params, batch)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    for k, gw in grads.items():
        assert _rel_l2(got["grads"][k], gw.numpy()) <= GRAD_RL2, k
    state, met = make_train_step(cfg, AdamWConfig(**OPT))(state, batch)
    np.testing.assert_allclose(got["grad_norm"], float(met["grad_norm"]), rtol=LOSS_RTOL)
    for k, w in state.params.named_parameters():
        assert _rel_l2(got["params"][k], w.detach().numpy()) <= GRAD_RL2, k
    assert got["restored"]   # Checkpointer.restore(shardings=) re-places bit for bit

    # ... and against the JAX package's own step on a (2, 2) mesh
    for key in ("loss", "step_loss", "grad_norm"):
        np.testing.assert_allclose(got[key], ref[key], rtol=LOSS_RTOL)
    for key in ("grads", "params"):
        mine = _leaves(to_reference_tree({k: np.array(v, np.float32)
                                          for k, v in got[key].items()}))
        theirs = _leaves(ref[key])
        assert set(mine) == set(theirs)
        errs = {k: _rel_l2(mine[k], theirs[k]) for k in theirs}
        worst = max(errs, key=errs.get)
        print(f"{key} against the reference: worst leaf {worst} rel L2 {errs[worst]:.3g}")
        assert errs[worst] <= GRAD_RL2, (key, worst, errs[worst])

    # decode on the sequence-sharded cache: the rows land where the
    # reference writes them, and the logits agree
    for pos, a, b in zip(DECODE_POS, got["decode"], ref["decode"]):
        print(f"decode at {pos}: logits max abs err {np.abs(np.subtract(a, b)).max():.3g}")
        np.testing.assert_allclose(np.array(a), np.array(b), rtol=DECODE_RTOL, atol=DECODE_ATOL,
                                   err_msg=f"pos {pos}")
    for k in ("k", "v"):
        a, b = np.array(got["cache"][k]), np.array(ref["cache"][k])
        np.testing.assert_allclose(a, b, rtol=DECODE_RTOL, atol=DECODE_ATOL, err_msg=k)
        written = np.zeros(a.shape[2], bool)
        written[list(DECODE_POS)] = True
        assert (a[:, :, written] != cache0[k][:, :, written]).all(), k
        np.testing.assert_array_equal(a[:, :, ~written], cache0[k][:, :, ~written])
