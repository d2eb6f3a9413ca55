"""Every family of the port's model zoo against the JAX package, on the CPU:
``params_from_jax``, ``init_fn``, ``input_specs`` and ``scan_trip_hints``
for all ten archs; the engine's cast-once params for every family; then the
hybrid (jamba) and vision-stub (internvl2) smoke models whole in bf16
(``torch_families``; the MoE, ssm and encoder-decoder families are held
whole in ``test_torch_moe.py``, ``test_torch_ssm.py`` and
``test_torch_whisper.py``, the dense family in ``test_torch_models.py``).
"""
import jax
import numpy as np
import pytest
import torch

import torch_families as tf
from repro.configs import registry as jreg
from repro.models import model as JM
from repro_torch.configs import registry as reg
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import CDTYPE
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import cast_matrices


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_params_from_jax_is_exact(arch):
    """Every leaf of the reference's params lands in the port bit for bit:
    stacked leaves (``blocks``, the hybrid's ``blocks.sub{i}``, whisper's
    ``enc``/``dec``) split along axis 0, the rest copied."""
    cfg_j, cfg = jreg.get_smoke_config(arch), reg.get_smoke_config(arch)
    rng = np.random.default_rng(0)   # distinct values in every leaf, the reference's shapes
    pj = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                      jax.eval_shape(lambda: JM.init_fn(cfg_j, jax.random.PRNGKey(0))))
    pt = params_from_jax(cfg, pj, device="cpu")
    got = dict(pt.named_parameters())
    n = 0
    for name, a in _flat(pj):
        parts = name.split(".")
        if parts[0] in ("blocks", "enc", "dec"):   # stacked: one port module per layer
            for i in range(a.shape[0]):
                w = got[".".join([parts[0], str(i)] + parts[1:])]
                np.testing.assert_array_equal(w.numpy(), a[i], err_msg=name)
                n += 1
        else:
            np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)
            n += 1
    assert n == len(got)
    assert sum(w.numel() for w in pt.parameters()) == sum(x.size for x in jax.tree.leaves(pj))
    bad = dict(pj, final_norm={})
    with pytest.raises(KeyError):
        params_from_jax(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_init_fn_shapes_are_the_references(arch):
    cfg_j, cfg = jreg.get_smoke_config(arch), reg.get_smoke_config(arch)
    p = M.init_fn(cfg, torch.Generator(device="cpu").manual_seed(0))
    q = M.init_fn(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), q.parameters()))
    shapes = jax.eval_shape(lambda: JM.init_fn(cfg_j, jax.random.PRNGKey(0)))
    assert sum(w.numel() for w in p.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert all(w.dtype == torch.float32 and not w.requires_grad for w in p.parameters())


@pytest.mark.parametrize("cell", reg.SHAPES, ids=lambda c: c.name)
@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_input_specs_and_scan_trip_hints(arch, cell):
    cfg_j, cfg = jreg.get_config(arch), reg.get_config(arch)
    got = M.input_specs(cfg, cell.seq_len, cell.global_batch, cell.mode)
    want = JM.input_specs(cfg_j, cell.seq_len, cell.global_batch, cell.mode)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for chunk in (1, 8):
        assert (M.scan_trip_hints(cfg, cell.seq_len, cell.mode, slstm_chunk=chunk)
                == JM.scan_trip_hints(cfg_j, cell.seq_len, cell.mode, slstm_chunk=chunk))
    with pytest.raises(ValueError):
        M.input_specs(cfg, cell.seq_len, cell.global_batch, "serve")


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_cast_once_params_give_the_same_values(arch):
    """The Engine's params (matrices cast to bf16 once) give bit for bit
    what the f32 masters give: every matrix of every family is used only
    after a cast to the compute dtype."""
    cfg = reg.get_smoke_config(arch)
    p = M.init_fn(cfg, torch.Generator(device="cpu").manual_seed(1))
    cp = cast_matrices(p, CDTYPE)
    assert {n for n, w in cp.named_parameters() if w.dtype == CDTYPE} == {
        n for n, w in p.named_parameters() if w.dim() >= 2}
    b = tf.torch_batch(tf.batch(cfg, 2, 16, seed=3))
    for ctx in (ShardCtx(), ShardCtx(use_flash=True)):
        out, cout = M.prefill_fn(cfg, p, b, ctx), M.prefill_fn(cfg, cp, b, ctx)
        for x, y in zip(out if isinstance(out, tuple) else [out],
                        cout if isinstance(cout, tuple) else [cout]):
            assert torch.equal(x, y)
    caches = [M.init_cache(cfg, 2, 8, device="cpu") for _ in range(2)]
    toks = torch.from_numpy(tf.tokens(cfg, 2, 4, seed=4)).long()
    for i in range(4):
        a, _ = M.decode_fn(cfg, p, toks[:, i:i + 1], caches[0], i)
        c, _ = M.decode_fn(cfg, cp, toks[:, i:i + 1], caches[1], i)
        assert torch.equal(a, c)


# ---- the hybrid and vision-stub families whole, in bf16 --------------------------------

@pytest.fixture(scope="module", params=["jamba-v0.1-52b", "internvl2-76b"])
def fam(request):
    return tf.Family(request.param)


@pytest.mark.parametrize("knobs", [{"use_flash": True}, {},
                                   {"use_flash": True, "cast_params_once": True}],
                         ids=["flash", "dense", "flash_cast_once"])
def test_prefill_fn_bf16(fam, knobs):
    tf.check_prefill(fam, knobs)


def test_decode_fn_steps_bf16(fam):
    tf.check_decode(fam)


def test_loss_fn_bf16(fam):
    tf.check_loss(fam)


def test_engine_greedy_matches_reference(fam):
    tf.check_engine(fam)
