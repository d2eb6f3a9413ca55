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
* In the same world, the step's loss and gradients on a (1, 4) mesh, whose
  4 model ranks the smoke config's 2 kv heads do not divide, so attention
  is split by (batch row, kv group) units (through ``_sdpa`` and through
  the flash kernel's plain version), against the one-device port and the
  JAX package's own on a (1, 4) mesh, at the same tolerances; whisper's
  step with 2 heads (encoder, decoder and cross-attention split alike),
  again with a vocab of 259 that the model ranks split unevenly, xlstm's
  step (products replicated) and two llama decode steps on a replicated
  cache of 18 rows, against the one-device port; jamba's step without
  experts on the (2, 2) mesh (the SSD on each model rank's heads) against
  the one-device port; and ``compressed_psum`` on the four ranks:
  all-reduces of the f32 scales and the int32 payloads, bit for bit the
  all-gathered values' reduction.
The world and the reference are spawned once (the ``world`` fixture).
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
OPT, DECODE_POS, SPLIT_FLASH = {OPT!r}, {DECODE_POS!r}, {SPLIT_FLASH!r}
SPLIT_DECODE_POS = {SPLIT_DECODE_POS!r}
UNEVEN_VOCAB = {UNEVEN_VOCAB!r}
MIXERS = {MIXERS!r}

def whisper_batch(cfg):
    """The (1, 4) whisper step's batch: 16 frames, 8 tokens a row."""
    rng = np.random.default_rng(5)
    return {"frames": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)}

def split_cache(cfg):
    """The (1, 4) decode's starting cache: random rows, 18 of them."""
    from repro_torch.models import model as M
    shape = M.init_cache(cfg, 4, 18, device="cpu")["k"].shape
    rng = np.random.default_rng(4)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}

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

# compressed_psum on the world: its all-reduces against the all-gather of
# every rank's values and their stacked reduction, bit for bit
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.train import compression as C

class Collectives(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            ts = [t for a in args for t in (a if isinstance(a, (list, tuple)) else [a])
                  if isinstance(t, torch.Tensor)]
            self.seen.append([func._schema.name, str(ts[0].dtype), ts[0].numel()])
        return func(*args, **(kwargs or {}))

prng = np.random.default_rng(3)
pg = torch.from_numpy(prng.standard_normal((4, 3000)).astype(np.float32))
pr = torch.from_numpy((prng.standard_normal((4, 3000)) * 0.01).astype(np.float32))
with Collectives() as seen:
    pout, pres = C.compressed_psum(pg[rank], pr[rank])
gs, rs = [torch.empty(3000) for _ in range(4)], [torch.empty(3000) for _ in range(4)]
dist.all_gather(gs, pg[rank])
dist.all_gather(rs, pr[rank])
want_out, want_res = C.reduce_compressed(torch.stack(gs), torch.stack(rs))
assert torch.equal(pout, want_out[rank]) and torch.equal(pres, want_res[rank]), rank
out["psum"] = seen.seen

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

# the same loss and gradients on a (1, 4) mesh: the 2 kv heads do not divide
# the 4 model ranks, so attention is split by (batch row, kv group) units,
# through _sdpa and through the flash kernel's plain version
mesh14 = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
out["split"] = {}
for flash in SPLIT_FLASH:
    c14 = ShardCtx(mesh=mesh14, use_flash=flash)
    st = SH.shard_state(init_train_state(cfg, 0, "cpu"), mesh14)
    b14 = {"tokens": tok, "labels": lab}
    b14 = SH.place_tree(b14, SH.batch_specs(cfg, b14, c14), mesh14)
    l14, g14 = loss_and_grads(cfg, st.params, b14, c14)
    out["split"][str(flash)] = {"loss": float(l14.full_tensor()),
                                "grads": {k: v.full_tensor().numpy().tolist()
                                          for k, v in g14.items()}}

# whisper's encoder, decoder and cross-attention on the (1, 4) mesh, with 2
# heads, which the 4 model ranks do not divide
wcfg = dataclasses.replace(reg.get_smoke_config("whisper-tiny"), num_heads=2, num_kv_heads=2)
wb = {k: torch.from_numpy(v) for k, v in whisper_batch(wcfg).items()}
wb = SH.place_tree(wb, SH.batch_specs(wcfg, wb, ShardCtx(mesh=mesh14)), mesh14)
wl, wg = loss_and_grads(wcfg, SH.shard_state(init_train_state(wcfg, 0, "cpu"), mesh14).params,
                        wb, ShardCtx(mesh=mesh14))
out["split_whisper"] = {"loss": float(wl.full_tensor()),
                        "grads": {k: v.full_tensor().numpy().tolist() for k, v in wg.items()}}

# whisper with a vocab that the 4 model ranks do not divide: the tied
# embedding is replicated (sanitize_spec) and the unembed's columns are split
# unevenly (65, 65, 65, 64)
ucfg = dataclasses.replace(wcfg, vocab_size=UNEVEN_VOCAB)
ub = {k: torch.from_numpy(v) for k, v in whisper_batch(ucfg).items()}
ub = SH.place_tree(ub, SH.batch_specs(ucfg, ub, ShardCtx(mesh=mesh14)), mesh14)
ul, ug = loss_and_grads(ucfg, SH.shard_state(init_train_state(ucfg, 0, "cpu"), mesh14).params,
                        ub, ShardCtx(mesh=mesh14))
out["uneven_vocab"] = {"loss": float(ul.full_tensor()),
                       "grads": {k: v.full_tensor().numpy().tolist() for k, v in ug.items()}}

# Mamba (jamba's smoke config without its experts) on the (2, 2) mesh, whose
# 2 model ranks split its 2 SSD heads, and xLSTM (its products replicated,
# as its weights are) on the (1, 4) mesh
out["mixers"] = {}
for arch, mesh_shape in MIXERS:
    mcfg = dataclasses.replace(reg.get_smoke_config(arch), num_experts=0)
    mm = mesh if mesh_shape == (2, 2) else mesh14
    mctx = ShardCtx(mesh=mm)
    mb = SH.place_tree({"tokens": tok, "labels": lab},
                       SH.batch_specs(mcfg, {"tokens": tok, "labels": lab}, mctx), mm)
    ml, mg = loss_and_grads(mcfg, SH.shard_state(init_train_state(mcfg, 0, "cpu"), mm).params,
                            mb, mctx)
    out["mixers"][arch] = {"loss": float(ml.full_tensor()),
                           "grads": {k: v.full_tensor().numpy().tolist() for k, v in mg.items()}}

# decode on the (1, 4) mesh against a cache of 18 rows, which the 4 model
# ranks divide no more than its 2 kv heads: the cache stays replicated and
# each rank attends its units of it
c14 = ShardCtx(mesh=mesh14)
rparams = SH.shard_params(M.init_fn(cfg, 0, "cpu"), mesh14)
rcache = {k: torch.from_numpy(v) for k, v in split_cache(cfg).items()}
rcache = SH.place_tree(rcache, SH.cache_specs(cfg, rcache, c14), mesh14)
assert all(t.placements[1] == Replicate() for t in rcache.values())   # over model
rtok = {"tokens": torch.arange(4, dtype=torch.int32)[:, None]}
rtok = SH.place_tree(rtok, SH.batch_specs(cfg, rtok, c14), mesh14)["tokens"]
out["split_decode"] = {
    "logits": [M.decode_fn(cfg, rparams, rtok, rcache, pos, c14)[0].full_tensor().tolist()
               for pos in SPLIT_DECODE_POS],
    "cache": {k: t.full_tensor().tolist() for k, t in rcache.items()}}

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
def place(tree, specs, mesh=mesh):
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

# the loss and gradients on a (1, 4) mesh
mesh14 = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
ctx14 = ShardCtx(mesh=mesh14)
p14 = place(jax.tree.map(jnp.asarray, to_reference_tree(named)), JSH.param_specs(params), mesh14)
b14 = place({k: np.asarray(v) for k, v in batch.items()},
            JSH.batch_specs(cfg, batch, ctx14), mesh14)
loss14, grads14 = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(cfg, p, b, ctx14)))(p14, b14)
out["split"] = {"loss": float(loss14), "grads": host(grads14)}

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
SPLIT_FLASH = (False, True)     # the (1, 4) mesh's attention: _sdpa, flash
SPLIT_DECODE_POS = (5, 17)      # its decode steps, into a cache of 18 rows
UNEVEN_VOCAB = 259              # a vocab the (1, 4) mesh's model ranks do not divide
MIXERS = (("jamba-v0.1-52b", (2, 2)), ("xlstm-125m", (1, 4)))   # arch, mesh


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text.replace("{OPT!r}", repr(OPT)).replace("{DECODE_POS!r}",
                                                                repr(DECODE_POS))
                    .replace("{SPLIT_FLASH!r}", repr(SPLIT_FLASH))
                    .replace("{SPLIT_DECODE_POS!r}", repr(SPLIT_DECODE_POS))
                    .replace("{UNEVEN_VOCAB!r}", repr(UNEVEN_VOCAB))
                    .replace("{MIXERS!r}", repr(MIXERS)))
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four gloo ranks and the JAX package's reference, spawned once:
    (the ranks' results, the reference's, the decode cache they started
    from)."""
    import json

    from repro_torch.configs import registry as reg
    from repro_torch.models import model as M

    tmp_path = tmp_path_factory.mktemp("world")
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
    return got, ref, cache0


def _f32(monkeypatch):
    for m in ("layers", "model", "transformer", "whisper"):
        monkeypatch.setattr(__import__(f"repro_torch.models.{m}", fromlist=["x"]), "CDTYPE",
                            torch.float32)


def _held_against_reference(got, ref, key):
    from repro_torch.models.convert import to_reference_tree
    mine = _leaves(to_reference_tree({k: np.array(v, np.float32) for k, v in got.items()}))
    theirs = _leaves(ref)
    assert set(mine) == set(theirs)
    errs = {k: _rel_l2(mine[k], theirs[k]) for k in theirs}
    worst = max(errs, key=errs.get)
    print(f"{key} against the reference: worst leaf {worst} rel L2 {errs[worst]:.3g}")
    assert errs[worst] <= GRAD_RL2, (key, worst, errs[worst])


def test_two_by_two_gloo_world_matches_one_device(monkeypatch, world):
    from repro_torch.configs import registry as reg
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, loss_and_grads, make_train_step

    got, ref, cache0 = world
    _f32(monkeypatch)
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
        _held_against_reference(got[key], ref[key], key)

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


@pytest.mark.parametrize("flash", SPLIT_FLASH, ids=["sdpa", "flash"])
def test_one_by_four_mesh_splits_attention_by_units(monkeypatch, world, flash):
    """On the (1, 4) mesh of the same world the llama smoke config's 2 kv
    heads do not divide the 4 model ranks: each rank attends its share of
    the (batch row, kv group) units (``attention._on_rank_share``), moved
    there by all-to-all. Its loss and gradients against the one-device port
    and the JAX package's step on a (1, 4) mesh."""
    from repro_torch.configs import registry as reg
    from repro_torch.train.train_step import init_train_state, loss_and_grads

    got, ref, _ = world
    split = got["split"][str(flash)]
    _f32(monkeypatch)
    cfg = reg.get_smoke_config("llama3.2-3b")
    assert cfg.num_kv_heads % 4 and cfg.num_heads % 4 == 0
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    loss, grads = loss_and_grads(cfg, init_train_state(cfg, 0, "cpu").params, batch)
    np.testing.assert_allclose(split["loss"], float(loss), rtol=LOSS_RTOL)
    for k, gw in grads.items():
        assert _rel_l2(split["grads"][k], gw.numpy()) <= GRAD_RL2, k
    np.testing.assert_allclose(split["loss"], ref["split"]["loss"], rtol=LOSS_RTOL)
    _held_against_reference(split["grads"], ref["split"]["grads"], "grads")


def test_compressed_psum_on_the_world(world):
    """``compressed_psum`` on the four gloo ranks equals the all-gather of
    every rank's values reduced together (``reduce_compressed``) bit for bit
    (held on each rank), and moves what the reference's ``pmax`` and
    ``psum`` move: an all-reduce of the f32 scales (one a chunk of 2048),
    then one of the int32 payloads; no all-gather."""
    got, _, _ = world
    chunks = -(-3000 // 2048)
    assert got["psum"] == [["c10d::allreduce_", "torch.float32", chunks],
                           ["c10d::allreduce_", "torch.int32", chunks * 2048]]


def test_one_by_four_decode_on_a_replicated_cache(monkeypatch, world):
    """Decode on the (1, 4) mesh against a cache of 18 rows: neither its
    length nor the 2 kv heads divide the 4 model ranks, so the cache stays
    replicated and each rank attends its (batch row, kv group) units of it.
    The logits and the written rows against the one-device port."""
    from repro_torch.configs import registry as reg
    from repro_torch.models import model as M

    got = world[0]["split_decode"]
    _f32(monkeypatch)
    cfg = reg.get_smoke_config("llama3.2-3b")
    params = M.init_fn(cfg, 0, "cpu")
    shape = M.init_cache(cfg, 4, 18, device="cpu")["k"].shape
    rng = np.random.default_rng(4)
    cache = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for k in ("k", "v")}
    tok = torch.arange(4, dtype=torch.int32)[:, None]
    for pos, logits in zip(SPLIT_DECODE_POS, got["logits"]):
        want = M.decode_fn(cfg, params, tok, cache, pos)[0]
        np.testing.assert_allclose(np.array(logits), want.numpy(), rtol=DECODE_RTOL,
                                   atol=DECODE_ATOL, err_msg=f"pos {pos}")
    for k in ("k", "v"):
        np.testing.assert_allclose(np.array(got["cache"][k]), cache[k].numpy(),
                                   rtol=DECODE_RTOL, atol=DECODE_ATOL, err_msg=k)


def test_one_by_four_whisper_splits_cross_attention_by_units(monkeypatch, world):
    """whisper's encoder, decoder and cross-attention (``_attn_ctx``: the
    mesh alone) with 2 heads on the (1, 4) mesh: each rank attends its
    units of every attention. Loss and gradients against the one-device
    port."""
    from repro_torch.configs import registry as reg
    from repro_torch.train.train_step import init_train_state, loss_and_grads

    got = world[0]["split_whisper"]
    _f32(monkeypatch)
    cfg = dataclasses.replace(reg.get_smoke_config("whisper-tiny"), num_heads=2, num_kv_heads=2)
    rng = np.random.default_rng(5)
    batch = {"frames": torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model))
                                        .astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))}
    loss, grads = loss_and_grads(cfg, init_train_state(cfg, 0, "cpu").params, batch)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    for k, gw in grads.items():
        assert _rel_l2(got["grads"][k], gw.numpy()) <= GRAD_RL2, k


def test_one_by_four_uneven_vocab_shards(monkeypatch, world):
    """whisper (2 heads) with a vocab of 259 on the (1, 4) mesh: the 4
    model ranks do not divide it, so the tied embedding is replicated and
    each rank computes its columns of the unembed, 65, 65, 65 and 64 of
    them. Every rank must agree on the logits' global shape, or the
    vocab-parallel loss takes the last rank's slice from the wrong offset.
    Loss and gradients against the one-device port."""
    from repro_torch.configs import registry as reg
    from repro_torch.train.train_step import init_train_state, loss_and_grads

    got = world[0]["uneven_vocab"]
    _f32(monkeypatch)
    cfg = dataclasses.replace(reg.get_smoke_config("whisper-tiny"), num_heads=2, num_kv_heads=2,
                              vocab_size=UNEVEN_VOCAB)
    rng = np.random.default_rng(5)
    batch = {"frames": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)}
    # the labels reach the last rank's slice (195..258) and the others
    assert (batch["labels"] >= 195).any() and (batch["labels"] < 195).any()
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = loss_and_grads(cfg, init_train_state(cfg, 0, "cpu").params, batch)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    for k, gw in grads.items():
        assert _rel_l2(got["grads"][k], gw.numpy()) <= GRAD_RL2, k


@pytest.mark.parametrize("arch,mesh_shape", MIXERS, ids=[a for a, _ in MIXERS])
def test_mamba_and_xlstm_on_a_mesh(monkeypatch, world, arch, mesh_shape):
    """jamba's smoke config (its experts taken out) on the (2, 2) mesh: u
    and z from in_proj's halves, each column-parallel, and the SSD on each
    model rank's heads (``mamba._ssd``, B and C whole, their gradients
    summed over the ranks). xlstm's on the (1, 4) mesh: every product
    replicated over the model ranks, as the reference keeps its weights.
    Loss and gradients against the one-device port."""
    from repro_torch.configs import registry as reg
    from repro_torch.train.train_step import init_train_state, loss_and_grads

    got = world[0]["mixers"][arch]
    _f32(monkeypatch)
    cfg = dataclasses.replace(reg.get_smoke_config(arch), num_experts=0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (4, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    loss, grads = loss_and_grads(cfg, init_train_state(cfg, 0, "cpu").params, batch)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    for k, gw in grads.items():
        assert _rel_l2(got["grads"][k], gw.numpy()) <= GRAD_RL2, k
