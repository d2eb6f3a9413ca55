"""Decoder-only LM for the dense, MoE, hybrid, SSM and VLM families.

The port of ``repro/models/transformer.py``. The reference stacks each
block's params along a leading axis and scans over it; here each layer is
a module of its own and the scan is a Python loop:

* dense/moe/vlm: ``blocks``, an ``nn.ModuleList`` of L ``Block``s;
* hybrid: ``blocks``, L / attn_period super-blocks, each an
  ``nn.ModuleDict`` of sub-layers ``sub0`` .. (the Jamba 1:7 pattern, MoE
  on every other sub-layer);
* ssm: unstacked ``layer0`` .. ``layer{L-1}`` (xLSTM blocks);
* vlm: text tokens after precomputed patch embeddings (``patch_proj``, the
  frontend stub).

``lm_loss`` is the training objective, differentiable: with grad mode on,
``backbone`` recomputes each layer in the backward pass as ``ctx.remat``
says (``sharding.remat``: per block, per hybrid super-block, per xLSTM
layer, as the reference's ``jax.checkpoint``); the prefill keeps every
layer's forward only (``remat=False``), as the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from . import mamba as mb
from . import xlstm as xl
from .config import ModelConfig
from .layers import (CDTYPE, apply_mlp, apply_norm, embed_params, embed_tokens,
                     mlp_params, norm_params, param, softmax_xent, unembed)
from .moe import apply_moe, moe_params
from .sharding import ShardCtx, batch_spec, constrain, dense, remat as _remat


def _split_kind(kind: str) -> tuple[str, str]:
    mixer, ff = (kind.split("+") + ["none"])[:2]
    return mixer, ff


class Block(nn.ModuleDict):
    """One layer of kind ``mixer+ff`` (e.g. ``attn+mlp``, ``mamba+moe``,
    ``slstm``): ``norm1``, ``norm2``, the mixer's group (``attn``, ``mamba``,
    ``mlstm`` or ``slstm``) and the feed-forward's (``mlp`` or ``moe``), as
    the reference's ``_block_params``."""

    def __init__(self, cfg: ModelConfig, kind: str, generator=None, device=None, V: int = 1):
        mixer, ff = _split_kind(kind)
        make_mixer = {"attn": attn.attn_params, "mamba": mb.mamba_params,
                      "mlstm": xl.mlstm_params, "slstm": xl.slstm_params}
        groups = {"norm1": norm_params(cfg, generator, device),
                  "norm2": norm_params(cfg, generator, device),
                  mixer: make_mixer[mixer](cfg, generator, device)}
        if ff == "mlp":
            groups["mlp"] = mlp_params(cfg, generator, device)
        elif ff == "moe":
            groups["moe"] = moe_params(cfg, generator, device, V=V)
        super().__init__(groups)


class DecoderLM(nn.Module):
    """The params of a decoder-only LM: ``embed`` (``tok``, ``out``),
    ``final_norm``, the layers (see the module docstring) and, for the
    vision stub, ``patch_proj``. Drawn from ``generator`` on its device, or
    left uninitialised on ``device`` when ``generator`` is None. ``V``: the
    MoE's virtual expert shards (``moe.moe_layout``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None, V: int = 1):
        super().__init__()
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder: see whisper.EncDecLM")
        self.cfg = cfg
        dev = generator.device if generator is not None else device
        self.embed = embed_params(cfg, generator, device)
        self.final_norm = norm_params(cfg, generator, device)
        kinds = cfg.layer_kinds()
        if cfg.family == "hybrid":
            self.blocks = nn.ModuleList(
                nn.ModuleDict({f"sub{i}": Block(cfg, kind, generator, device, V)
                               for i, kind in enumerate(kinds)})
                for _ in range(cfg.num_layers // cfg.attn_period))
        elif cfg.family == "ssm":
            for i, kind in enumerate(kinds):
                self.add_module(f"layer{i}", Block(cfg, kind, generator, device, V))
        else:
            self.blocks = nn.ModuleList(Block(cfg, kinds[0], generator, device, V)
                                        for _ in range(cfg.num_layers))
        if cfg.frontend == "vision_stub":   # stub projector
            self.patch_proj = param(torch.eye(cfg.d_model, dtype=torch.float32, device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def layers(self):
        """The layers in order: Blocks, or the hybrid's super-blocks."""
        if self.cfg.family == "ssm":
            return [getattr(self, f"layer{i}") for i in range(self.cfg.num_layers)]
        return list(self.blocks)


def init_params(cfg: ModelConfig, generator: torch.Generator, V: int = 1) -> DecoderLM:
    return DecoderLM(cfg, generator, V=V)


def cast_matrices(params: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``params`` (a ``DecoderLM`` or ``whisper.EncDecLM``) whose
    matrices are cast to ``dtype``; the vectors (norms, biases, gates) are
    shared, still f32. Every matrix is used only after a cast to the
    compute dtype, so the copy gives the same values in it."""
    out = type(params)(params.cfg, device="meta")
    with torch.no_grad():
        for name, w in params.named_parameters():
            set_param(out, name, param(w.to(dtype)) if w.dim() >= 2 else w)
    return out


def set_param(model: nn.Module, name: str, p: nn.Parameter) -> None:
    """Put ``p`` at the dotted parameter name ``name`` of ``model``."""
    mod, _, leaf = name.rpartition(".")
    owner = model.get_submodule(mod)
    if isinstance(owner, nn.ParameterDict):
        owner[leaf] = p
    else:
        setattr(owner, leaf, p)


def _cast_block(p: nn.Module) -> dict:
    """Every f32 param of a layer in bf16 (the reference's cast_params_once
    casts every f32 leaf of the stacked blocks, norms included)."""
    if isinstance(p, Block):
        return {name: {k: (w.to(CDTYPE) if w.dtype == torch.float32 else w)
                       for k, w in group.items()}
                for name, group in p.items()}
    return {name: _cast_block(sub) for name, sub in p.items()}


def _seq_ax(ctx: ShardCtx | None):
    return "model" if (ctx is not None and ctx.attn_seq_shard) else None


def _apply_block(cfg: ModelConfig, p, x, kind: str, ctx: ShardCtx | None):
    bs, sq = batch_spec(ctx), _seq_ax(ctx)
    mixer, ff = _split_kind(kind)
    h = apply_norm(cfg, p["norm1"], x)
    if mixer == "attn":
        out = attn.self_attention(cfg, p["attn"], h, causal=True,
                                  bf16=bool(ctx and ctx.bf16_attn), ctx=ctx)
    elif mixer == "mamba":
        out = mb.apply_mamba(cfg, p["mamba"], h)
    elif mixer == "mlstm":
        out = xl.apply_mlstm(cfg, p["mlstm"], h)
    elif mixer == "slstm":
        out = xl.apply_slstm(cfg, p["slstm"], h,
                             time_chunk=(ctx.slstm_chunk if ctx else 1))
    else:
        raise ValueError(kind)
    x = x + constrain(ctx, out, bs, sq, None)
    if ff == "none":
        return x
    h = apply_norm(cfg, p["norm2"], x)
    out = apply_moe(cfg, p["moe"], h, ctx) if ff == "moe" else apply_mlp(cfg, p["mlp"], h)
    return x + constrain(ctx, out, bs, sq, None)


def backbone(cfg: ModelConfig, params: DecoderLM, x, ctx: ShardCtx | None,
             remat: bool = True):
    """x [B,S,D] -> [B,S,D] hidden states; ``remat``: each layer (a hybrid
    super-block) is recomputed in the backward pass as ``ctx.remat`` says."""
    kinds = cfg.layer_kinds()
    cast = ctx is not None and ctx.cast_params_once and cfg.family != "ssm"
    x = constrain(ctx, x, batch_spec(ctx), _seq_ax(ctx), None)

    def layer_fn(i, layer):
        def run(h):
            p = _cast_block(layer) if cast else layer
            if cfg.family == "hybrid":
                for j, kind in enumerate(kinds):
                    h = _apply_block(cfg, p[f"sub{j}"], h, kind, ctx)
                return h
            return _apply_block(cfg, p, h, kinds[i if cfg.family == "ssm" else 0], ctx)
        return run

    for i, layer in enumerate(params.layers()):
        run = layer_fn(i, layer)
        x = _remat(ctx, run, x) if remat else run(x)
    return apply_norm(cfg, params.final_norm, x)


def embed_inputs(cfg: ModelConfig, params: DecoderLM, batch, ctx: ShardCtx | None):
    """Token (and stub-modality) embedding. Returns (x [B,S,D], loss mask)."""
    tokens = batch["tokens"]
    x = embed_tokens(params.embed, tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    if cfg.frontend == "vision_stub":
        patches = dense(batch["patch_embeds"].to(CDTYPE), params.patch_proj)
        x = torch.cat([patches, x], dim=1)
        mask = torch.cat([torch.zeros(patches.shape[:2], dtype=torch.float32,
                                      device=mask.device), mask], dim=1)
    return x, mask


def lm_loss(cfg: ModelConfig, params: DecoderLM, batch, ctx: ShardCtx | None = None):
    """Next-token cross-entropy. batch: tokens [B,S], labels [B,S] (+stubs)."""
    x, mask = embed_inputs(cfg, params, batch, ctx)
    h = backbone(cfg, params, x, ctx)
    if cfg.frontend == "vision_stub":
        S_txt = batch["tokens"].shape[1]
        h = h[:, -S_txt:, :]   # loss over text positions
        mask = mask[:, -S_txt:]
    logits = unembed(cfg, params.embed, h)
    if _seq_ax(ctx):
        logits = constrain(ctx, logits, batch_spec(ctx), "model", None)
    else:
        logits = constrain(ctx, logits, batch_spec(ctx), None, "model")
    return softmax_xent(logits, batch["labels"], mask)


# ---------------------------------------------------------------------------
# decode (one token) + prefill
# ---------------------------------------------------------------------------

def _kv(cfg: ModelConfig, lead: tuple, batch: int, max_len: int, device):
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    shape = lead + (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CDTYPE, device=device),
            "v": torch.zeros(shape, dtype=CDTYPE, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Decode cache, laid out as the reference's: attention layers hold
    ``k``/``v`` ``[B, Smax(|window), Hkv, Dh]`` (stacked ``[L, ...]`` for
    dense/moe/vlm; ``sub{i}`` stacked over super-blocks for the hybrid),
    Mamba and xLSTM layers their recurrent states."""
    kinds = cfg.layer_kinds()
    if cfg.family == "hybrid":
        n_super = cfg.num_layers // cfg.attn_period
        cache = {}
        for i, kind in enumerate(kinds):
            if _split_kind(kind)[0] == "attn":
                cache[f"sub{i}"] = _kv(cfg, (n_super,), batch, max_len, device)
            else:
                st = mb.mamba_state_init(cfg, batch, device=device)
                cache[f"sub{i}"] = {k: v.expand((n_super,) + v.shape).clone()
                                    for k, v in st.items()}
        return cache
    if cfg.family == "ssm":
        return {f"layer{i}": (xl.slstm_state_init(cfg, batch, device) if k == "slstm"
                              else xl.mlstm_state_init(cfg, batch, device))
                for i, k in enumerate(kinds)}
    return _kv(cfg, (cfg.num_layers,), batch, max_len, device)


def _decode_block(cfg: ModelConfig, p, x, kind: str, cache, pos: int, ctx):
    """One layer's decode step; ``cache`` (this layer's slice) is updated
    in place: the attention rows are written into it, a recurrent state
    copied over it."""
    mixer, ff = _split_kind(kind)
    h = apply_norm(cfg, p["norm1"], x)
    if mixer == "attn":
        out, _, _ = attn.decode_attention(cfg, p["attn"], h, cache["k"], cache["v"], pos,
                                          ctx)
    else:
        step = {"mamba": mb.decode_mamba, "mlstm": xl.decode_mlstm,
                "slstm": xl.decode_slstm}[mixer]
        out, new = step(cfg, p[mixer], h, cache)
        for name, t in new.items():
            cache[name].copy_(t)
    x = x + out
    if ff != "none":
        h = apply_norm(cfg, p["norm2"], x)
        out = apply_moe(cfg, p["moe"], h, ctx) if ff == "moe" else apply_mlp(cfg, p["mlp"], h)
        x = x + out
    return x


def _slice(cache: dict, j: int) -> dict:
    return {name: t[j] for name, t in cache.items()}


def decode_step(cfg: ModelConfig, params: DecoderLM, tokens, cache, pos: int,
                ctx: ShardCtx | None = None):
    """tokens [B,1] -> (logits [B,1,V], cache). ``pos`` is the position of
    ``tokens``; the cache is updated in place."""
    kinds = cfg.layer_kinds()
    # batch-sharded rows under a mesh (XLA propagates the tokens' sharding;
    # DTensor's embedding rule would leave them partial)
    x = constrain(ctx, embed_tokens(params.embed, tokens), batch_spec(ctx), None, None)
    for j, layer in enumerate(params.layers()):
        if cfg.family == "ssm":
            x = _decode_block(cfg, layer, x, kinds[j], cache[f"layer{j}"], pos, ctx)
        elif cfg.family == "hybrid":
            for i, kind in enumerate(kinds):
                x = _decode_block(cfg, layer[f"sub{i}"], x, kind,
                                  _slice(cache[f"sub{i}"], j), pos, ctx)
        else:
            x = _decode_block(cfg, layer, x, kinds[0], _slice(cache, j), pos, ctx)
    x = apply_norm(cfg, params.final_norm, x)
    return unembed(cfg, params.embed, x), cache


def prefill(cfg: ModelConfig, params: DecoderLM, batch, ctx: ShardCtx | None = None):
    """Prefill forward: last-position logits [B,1,V] (no cache is written,
    as in the reference; the Engine fills its cache by decoding)."""
    x, _ = embed_inputs(cfg, params, batch, ctx)
    h = backbone(cfg, params, x, ctx, remat=False)
    return unembed(cfg, params.embed, h[:, -1:, :])
