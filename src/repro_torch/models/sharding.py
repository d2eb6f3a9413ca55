"""The sharding context threaded through the port's models.

The port of ``repro/models/sharding.py``. Models are written
sharding-agnostic; a ``ShardCtx`` (or ``None`` on one device) supplies the
mesh, its axis names and the knobs. Sharded execution is eager SPMD on
DTensor: the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension names are the reference's axis names (``"data"``, ``"model"``,
``"pod"``), a param or an activation is a ``DTensor``, a spec is the
reference's ``PartitionSpec`` as a tuple (one entry per tensor dim: ``None``,
an axis name, or a tuple of axis names, major first), and ``constrain`` is
``DTensor.redistribute`` to the placements the spec names
(``spec_placements``). Under a ``None`` mesh, or on a plain tensor,
``constrain`` is the identity, so the one-device path is unchanged.

``remat`` is the reference's training knob: the training loss recomputes
each layer (``transformer.backbone``: an xLSTM layer, a hybrid super-block,
a block; whisper's encoder and decoder layers) in the backward pass instead
of keeping its activations (``"full"``, the reference's default and what a
``None`` ctx gets), or keeps only the matrix products' outputs
(``"dots"``, the reference's ``dots_with_no_batch_dims_saveable``: the
``x @ w`` products, ``aten.mm``; attention's batched products are
recomputed). ``"none"`` (the port's own value) keeps every activation, to
measure what remat saves. It changes no value, only memory and time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: object = None            # DeviceMesh, or None: one device
    batch_axes: tuple[str, ...] = ("data",)   # ('pod', 'data') multi-pod
    model_axis: str = "model"
    bf16_attn: bool = False        # QK^T and RoPE in the compute dtype
    remat: str = "full"            # full | dots | none (see the docstring)
    weight_mode: str = "fsdp"      # fsdp | tp2d | seqpar (launch/shardings.py)
    cast_params_once: bool = False  # cast each block's f32 params to bf16
    # before it runs (the reference does it before the layer scan)
    attn_seq_shard: bool = False   # shard attention over the query sequence
    # (context parallelism) instead of heads
    use_flash: bool = False        # attention through the flash kernel
    # (kernels/flashattn.py): no [B, H, S, S] logits in device memory
    slstm_chunk: int = 1           # sLSTM timesteps per scan iteration of
    # the reference; run, the port steps one position at a time whatever it
    # is; the dry-run's recorder counts S / slstm_chunk iterations of it

    def __post_init__(self):
        if self.remat not in ("full", "dots", "none"):
            raise ValueError(f"remat must be 'full', 'dots' or 'none', got {self.remat!r}")
        if self.mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(self.mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh, got {type(self.mesh).__name__}")
        elif self.attn_seq_shard:
            raise ValueError("attn_seq_shard shards over the model axis: it needs a mesh")

    def axis_size(self, name: str) -> int:
        return axis_size(self.mesh, name)

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def batch_size(self) -> int:
        out = 1
        for a in self.batch_axes:
            out *= self.axis_size(a)
        return out

    def constrain(self, x, *spec):
        if self.mesh is None or not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, spec_placements(spec, self.mesh))


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 for a ``None`` mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_coord(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis ``name`` (a host int, so it
    traces as a constant)."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(name)])


def chunk_offset(mesh, dims, size: int) -> int:
    """This rank's first index along a dim of ``size`` sharded over the mesh
    dims ``dims``, major first (DTensor's shards are nested ``torch.chunk``s)."""
    coord, off = mesh.get_coordinate(), 0
    for i in dims:
        chunk = -(-size // mesh.size(i))
        start = min(int(coord[i]) * chunk, size)
        off, size = off + start, min(chunk, size - start)
    return off


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.
    A tensor dim over several axes names them major first, which is the
    order DTensor shards them in (mesh-dim order), so another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of spec {spec}")
            out[i] = Shard(d)
    return out


def split_ready(x, dim: int, n: int):
    """``x`` ready for its dim ``dim`` to be split into (n, rest): on a
    DTensor whose shards of that dim the n groups do not divide evenly,
    those mesh axes are gathered first (identity otherwise)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    axes = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    size = 1
    for i in axes:
        size *= x.device_mesh.size(i)
    if n % size == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if i in axes else p
                                          for i, p in enumerate(x.placements)])


class _SumOverAxes(torch.autograd.Function):
    """All-reduce (sum) a local tensor over process groups, with the
    identity as its backward: the sum is replicated, and every rank holds
    the same gradient of it (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x, *groups):
        c10d = torch.ops._c10d_functional
        for g in groups:
            x = c10d.wait_tensor(c10d.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + (None,) * len(ctx.needs_input_grad[1:])


def sum_over(x, mesh, dims):
    """``x`` (a local tensor inside ``local_map``) summed over the mesh
    dims ``dims`` (those of size 1 skipped), differentiably
    (``_SumOverAxes``)."""
    groups = [mesh.get_group(i).group_name for i in dims if mesh.size(i) > 1]
    return _SumOverAxes.apply(x, *groups) if groups else x


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of a local tensor over a process group (rows
    of dim 0 sent in ``in_splits`` to each rank, ``out_splits`` received
    from each); its backward sends the gradient back the same way."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (list(out_splits), list(in_splits)), group
        return _all_to_all(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, grad):
        out_splits, in_splits = ctx.splits
        return _all_to_all(grad.contiguous(), in_splits, out_splits, ctx.group), None, None, None


def _all_to_all(x, out_splits, in_splits, group):
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_to_all_single(x, list(out_splits), list(in_splits), group))


def all_to_all(x, mesh, dim: int, out_splits, in_splits):
    """``x`` (a local tensor inside ``local_map``) exchanged over mesh dim
    ``dim`` by rows of its dim 0, differentiably (``_AllToAll``)."""
    if mesh.size(dim) == 1:
        return x
    return _AllToAll.apply(x.contiguous(), tuple(out_splits), tuple(in_splits),
                           mesh.get_group(dim).group_name)


def product_plan(x, w, split_cols: bool = True):
    """The placements of ``x @ w`` (x ``[..., K]``, w ``[K, N]``, DTensors on
    one mesh), pinned mesh dim by mesh dim so that no choice is left to
    DTensor's sharding propagation, which differs between torch releases.
    Returns ``(x_pl, w_pl, out_pl, x_grad_pl, w_grad_pl, summed)``: the
    operands' placements, the result's, the operands' gradients', and the
    mesh dims over which each rank's product is a partial sum.

    On each mesh dim, as the reference's rule tables mean them
    (``launch/shardings.py``: weights ZeRO-sharded over the batch axes,
    tensor-parallel over ``model``):

    * x's rows (a dim other than the last) sharded there: the weight is
      gathered on it (ZeRO); the product is each rank's rows.
    * else the weight's K sharded there (row-parallel, ``wo``/``w_down``):
      x's features are sharded alike, and the partial products are summed.
    * else, where the weight is replicated there and ``split_cols`` is
      False: everything is replicated (the reference's replicated xLSTM
      weights, whose products every rank repeats).
    * else (the weight's N sharded, or nothing): the weight's N is sharded
      there (a local slice of a replicated weight, unevenly in
      ``torch.chunk``'s order where N does not divide) and x is replicated:
      each rank computes its columns (column-parallel, ``wq``/``w_up``/the
      unembed).
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    n, rows, summed = x.ndim, [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        # (x, w, out, x's gradient, w's gradient) on mesh dim i
        if isinstance(xp, Shard) and xp.dim % n != n - 1:
            rows.append((xp, Replicate(), xp, xp, Partial()))
        elif wp == Shard(0):
            rows.append((Shard(n - 1), wp, Replicate(), Shard(n - 1), wp))
            summed.append(i)
        elif wp == Replicate() and not split_cols:
            rows.append((Replicate(),) * 5)
        else:
            rows.append((Replicate(), Shard(1), Shard(n - 1), Partial(), Shard(1)))
    return (*(list(c) for c in zip(*rows)), summed)


def dense(x, w, bias=None, split_cols: bool = True):
    """``x @ w (+ bias)``, the weight and bias cast to x's dtype. On
    DTensors the operands are placed by ``product_plan`` (``split_cols``:
    see there) and each rank multiplies its shards (``run_local``), summing
    partial products over the mesh dims that need it; a plain ``x`` is the
    one-device product."""
    w = w.to(x.dtype)
    if not (is_dtensor(x) and is_dtensor(w)):
        out = x @ w
        return out if bias is None else out + bias.to(x.dtype)
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    x_pl, w_pl, out_pl, xg, wg, summed = product_plan(x, w, split_cols)
    out = run_local(lambda xl, wl: sum_over(xl @ wl, mesh, summed), mesh, (x, w), (x_pl, w_pl),
                    (xg, wg), out_pl, (*x.shape[:-1], w.shape[1]))
    if bias is None:
        return out
    bias = bias.to(x.dtype)
    if is_dtensor(bias):
        bias = bias.redistribute(mesh, [Shard(0) if p == Shard(x.ndim - 1) else Replicate()
                                        for p in out_pl])
    return out + bias


def run_local(fn, mesh, args, in_placements, grad_placements, out_placements, shape):
    """``fn`` on this rank's shards of ``args`` (DTensors, redistributed to
    ``in_placements``; their gradients come back in ``grad_placements``),
    its local result made a DTensor of the global ``shape`` with
    ``out_placements``. ``local_map`` does the same but infers the global
    shape from the local one as if every shard were even, so the ranks of
    an uneven split (``torch.chunk``'s order) would disagree on it."""
    from torch.distributed.tensor import DTensor
    local = [a.redistribute(mesh, pl).to_local(grad_placements=g)
             for a, pl, g in zip(args, in_placements, grad_placements)]
    stride, n = [], 1
    for d in reversed(shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(fn(*local), mesh, out_placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def constrain(ctx: ShardCtx | None, x, *spec):
    if ctx is None:
        return x
    return ctx.constrain(x, *spec)


def batch_spec(ctx: ShardCtx | None):
    if ctx is None or not ctx.batch_axes:
        return None
    return tuple(ctx.batch_axes) if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]


def on_mesh(ctx: ShardCtx | None):
    """The context a sharded forward runs in: under a mesh, plain tensors
    made inside the model (masks, RoPE angles, positions) join DTensor ops
    as replicated (``implicit_replication``, whose exit switches it off, so
    a nested entry, as the backward of a forward that entered it, is a
    no-op); else nothing."""
    if ctx is None or ctx.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        return contextlib.nullcontext()
    return implicit_replication()


def _save_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(ctx: ShardCtx | None, fn, *args):
    """``fn(*args)``, recomputed in the backward pass as ``ctx.remat`` says
    (a ``None`` ctx: ``"full"``). Without grad mode it is a plain call."""
    mode = ctx.remat if ctx is not None else "full"
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
    if mode == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_products))
    return checkpoint(fn, *args, use_reentrant=False)
