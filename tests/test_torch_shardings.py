"""The port's sharding rules (``repro_torch.launch.shardings``) and
production meshes (``launch.mesh.make_production_mesh``) against the JAX
package, on the CPU.

Specs: for every leaf of every arch's full config (the MoE at V = 16, the
production mesh's model axis), in the three weight modes, the port's spec
of its per-layer leaf equals the reference's spec of the stacked leaf
without the stacked dim (the reference side on ``jax.eval_shape``, the port
on the meta device). ``sanitize_spec``, ``batch_specs`` and ``cache_specs``
equal the reference's (which read only ``mesh.shape``, so its ``ShardCtx``
gets a stand-in). On torch's fake world of 256 and 512 ranks each leaf's
local shard shape equals the shape reckoned from the reference's sanitized
spec. Each test starts the fake world and destroys it.
"""
import contextlib
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import mesh as JMESH
from repro.launch import shardings as JSH
from repro.models import model as JM
from repro.models.sharding import ShardCtx as JShardCtx
from repro_torch.configs import registry as reg
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.models import model as M
from repro_torch.models.convert import reference_path
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.whisper import EncDecLM

V = 16
POD1 = {"data": 16, "model": 16}
POD2 = {"pod": 2, "data": 16, "model": 16}


@contextlib.contextmanager
def fake_world(n: int):
    MESH.start_fake_world(n)
    try:
        yield
    finally:
        MESH.stop_world()


def _port_params(cfg):
    return EncDecLM(cfg, device="meta") if cfg.is_encoder_decoder else \
        DecoderLM(cfg, device="meta", V=V)


def _ref_specs(cfg, mode):
    """{reference key path: (spec as a tuple, stacked shape)}."""
    abs_ = jax.eval_shape(lambda: JM.init_fn(cfg, jax.random.PRNGKey(0), V=V))
    specs = JSH.param_specs(abs_, mode)
    flat_s = jax.tree_util.tree_flatten_with_path(specs,
                                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    flat_a = dict(jax.tree_util.tree_flatten_with_path(abs_)[0])
    return {JSH._path_str(p): (tuple(s), tuple(flat_a[p].shape)) for p, s in flat_s}


def _ref_leaf(ref, name):
    """The reference's (spec, shape) of the port's parameter ``name``."""
    path, layer = reference_path(name)
    spec, shape = ref["/".join(path)]
    return (spec[1:], shape[1:]) if layer is not None else (spec, shape)


def _reckoned(shape, spec, axes):
    out = list(shape)
    for i, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            out[i] //= axes[a]
    return tuple(out)


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_param_specs_equal_the_references(arch):
    cfg = reg.get_config(arch)
    params = _port_params(cfg)
    named = dict(params.named_parameters())
    stand_in = types.SimpleNamespace(shape=POD2)
    with fake_world(512):
        mesh = MESH.make_production_mesh(multi_pod=True, device_type="cpu")
        for mode in ("fsdp", "tp2d", "seqpar"):
            ref = _ref_specs(jreg.get_config(arch), mode)
            got = SH.param_specs(params, mode)
            assert set(got) == set(named)
            for name, w in named.items():
                spec, shape = _ref_leaf(ref, name)
                assert tuple(w.shape) == shape, name
                assert got[name] == spec, (mode, name, got[name], spec)
                want = tuple(JSH.sanitize_spec(jax.sharding.PartitionSpec(*spec), shape,
                                               stand_in))
                assert SH.sanitize_spec(spec, shape, mesh) == want, (mode, name)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-tiny", "moonshot-v1-16b-a3b",
                                  "jamba-v0.1-52b", "mixtral-8x22b", "xlstm-125m"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_local_shapes_follow_the_reference_specs(arch, multi_pod):
    cfg = reg.get_config(arch)
    axes = POD2 if multi_pod else POD1
    stand_in = types.SimpleNamespace(shape=axes)
    mode = "tp2d" if arch == "llama3.2-3b" else "fsdp"
    ref = _ref_specs(jreg.get_config(arch), mode)
    with fake_world(512 if multi_pod else 256):
        mesh = MESH.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        params = SH.shard_params(_port_params(cfg), mesh, mode, meta=True)
        for name, w in params.named_parameters():
            spec, shape = _ref_leaf(ref, name)
            want_spec = tuple(JSH.sanitize_spec(jax.sharding.PartitionSpec(*spec), shape,
                                                stand_in))
            assert tuple(w.to_local().shape) == _reckoned(shape, want_spec, axes), name
            assert tuple(w.shape) == shape


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-tiny", "jamba-v0.1-52b",
                                  "xlstm-125m", "internvl2-76b"])
def test_batch_and_cache_specs_equal_the_references(arch):
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    stand_in = types.SimpleNamespace(shape=POD1)
    jctx = JShardCtx(mesh=stand_in, batch_axes=("data",))
    with fake_world(256):
        mesh = MESH.make_production_mesh(device_type="cpu")
        ctx = ShardCtx(mesh=mesh)
        for cell in jreg.SHAPES[:3]:
            specs = M.input_specs(cfg, cell.seq_len, cell.global_batch, cell.mode)
            jspecs = JM.input_specs(jcfg, cell.seq_len, cell.global_batch, cell.mode)
            want = jax.tree_util.tree_flatten_with_path(
                JSH.batch_specs(jcfg, jspecs, jctx),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
            assert SH.batch_specs(cfg, specs, ctx) == {JSH._path_str(p): tuple(s)
                                                       for p, s in want}
        B, S = 128, 32_768
        cache = M.init_cache(cfg, B, S, device="meta")
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S, V=V))
        want = jax.tree_util.tree_flatten_with_path(
            JSH.cache_specs(jcfg, jcache, jctx),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        got = SH.cache_specs(cfg, cache, ctx)
        assert got == {JSH._path_str(p): tuple(s) for p, s in want}
        shapes = dict((JSH._path_str(p), tuple(a.shape))
                      for p, a in jax.tree_util.tree_flatten_with_path(jcache)[0])
        assert {p: tuple(t.shape) for p, t in SH.tree_paths(cache)} == shapes


def test_production_mesh_rank_order():
    with fake_world(256):
        m = MESH.make_production_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        np.testing.assert_array_equal(m.mesh.numpy(), np.arange(256).reshape(16, 16))
        s = MESH.make_production_mesh(device_order="sharedmap", device_type="cpu")
        want = JMESH.sharedmap_device_order(multi_pod=False)
        np.testing.assert_array_equal(s.mesh.numpy().ravel(), want)
        np.testing.assert_array_equal(MESH.sharedmap_device_order(multi_pod=False), want)
        with pytest.raises(RuntimeError, match="world size 512"):
            MESH.make_production_mesh(multi_pod=True, device_type="cpu")
    with fake_world(512):
        m = MESH.make_production_mesh(multi_pod=True, device_type="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model")
        np.testing.assert_array_equal(m.mesh.numpy(), np.arange(512).reshape(2, 16, 16))


def test_production_mesh_raises_without_its_world():
    with pytest.raises(RuntimeError, match="world size 256; none is initialized"):
        MESH.make_production_mesh(device_type="cpu")
    with fake_world(4):
        with pytest.raises(RuntimeError, match="world size 256; it has 4"):
            MESH.make_production_mesh(device_type="cpu")
    with fake_world(256):
        with pytest.raises(ValueError):
            MESH.make_production_mesh(device_order="scrambled", device_type="cpu")


def test_spec_placements_order_and_constrain():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.sharding import spec_placements
    with fake_world(512):
        mesh = MESH.make_production_mesh(multi_pod=True, device_type="cpu")
        assert spec_placements((("pod", "data"), None, "model"), mesh) == \
            [Shard(0), Shard(0), Shard(2)]
        assert spec_placements((None, None), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError, match="mesh order"):
            spec_placements((("data", "pod"),), mesh)
        ctx = ShardCtx(mesh=mesh, batch_axes=("pod", "data"))
        assert (ctx.model_size, ctx.batch_size) == (16, 32)
        x = SH.to_meta(torch.empty(64, 8, 32, device="meta"), (("pod", "data"), None, None),
                       mesh)
        y = ctx.constrain(x, ("pod", "data"), None, "model")
        assert tuple(y.to_local().shape) == (2, 8, 2)
        plain = torch.ones(3)
        assert ctx.constrain(plain, "model") is plain
