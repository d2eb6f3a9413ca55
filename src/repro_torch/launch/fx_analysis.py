"""The graph of a ``torch.export`` program, read as ``hlo_analysis`` reads
an optimized HLO module: what each node computes and moves.

``torch.export.export`` of one of the port's losses gives an
``ExportedProgram`` whose graph holds ATen calls at the pre-dispatch level
(``matmul``, ``einsum``, ``softmax``, casts, views) with every loop of the
model unrolled, and a ``meta["val"]`` fake tensor (shape and dtype) on every
node. Nothing here runs the graph or needs a device.

* **FLOPs per node**, as ``hlo_analysis._dot_flops`` and its convolution
  rule count them: ``2 * numel(out) * K`` for the matrix products
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``matmul``; K the contracted
  size), ``2 *`` the product of every index size for ``einsum`` (counted
  here, so the graph need not be decomposed to ``mm``/``bmm``, which costs
  2-3x the export), ``2 * numel(out)`` for a convolution; 0 elsewhere.
* **Bytes per tensor**, from ``meta["val"]`` (a tuple's are summed).
* **Kinds.** A *source* is never a task and dataflow stops at it: a
  placeholder (parameter, buffer, input), a constant, or a call with no
  node among its arguments (``arange``, ``ones``, ``zeros``...), as
  ``comm_graph._SOURCES``. A *transparent* node is never a task and
  dataflow passes through it to the real producer, as
  ``comm_graph._TRANSPARENT``: ``getitem``, the views (an ATen op whose
  result aliases its input: ``reshape``, ``view``, ``permute``,
  ``transpose``, ``expand``, ``unsqueeze``, ``slice``, ``select``,
  ``chunk``...; casts excepted) and the ``_assert_*`` checks, which
  produce nothing. Every other call is a task. A task is *pointwise* when
  its ATen op carries ``torch.Tag.pointwise``, or is a cast or a mask
  (``to``, ``where``, ``&``...): the ops XLA's loop fusion merges.
* **Collectives.** A graph recorded per rank (``LocalRecorder`` over a step
  on DTensors, ``launch/dryrun.py``) holds local ATen ops and
  ``_c10d_functional`` collectives, the port's counterpart of the SPMD
  HLO. A collective (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce``, ``all_to_all_single``) is a task of the HLO kind
  ``collective_kind`` names, over a group of ``collective_group_size``
  ranks; its payload is its input's bytes (``analyze_hlo``'s operand
  bytes). ``wait_tensor`` is transparent.
* **Loop regions.** A node recorded inside a scan's loop region
  (``LocalRecorder.scan``) stands for every iteration the region replaces:
  ``meta["trips"]`` (1 when absent) multiplies its FLOPs, collective bytes
  and counts and HBM traffic (``node_trips``), as ``hlo_analysis`` scales a
  ``while`` body by its trip count; ``peak_live_bytes`` counts its buffers
  once, as a loop body's are reused.
"""
from __future__ import annotations

import operator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "matmul")
_CONVS = ("convolution", "conv1d", "conv2d", "_convolution")
# casts and masks are elementwise too, but carry no pointwise tag
_ALSO_POINTWISE = ("to", "_to_copy", "type_as", "where", "__and__", "__or__",
                   "bitwise_and", "bitwise_or", "logical_and", "logical_or",
                   "logical_not", "masked_fill", "clone")


# _c10d_functional op -> the HLO collective kind (hlo_analysis._COLLECTIVES)
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all"}


def _op_name(node) -> str:
    """The ATen op's base name (``aten.matmul.default`` -> ``matmul``)."""
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return target._schema.name.split("::")[-1]
    return getattr(target, "__name__", str(target))


def _val(node):
    return node.meta.get("val") if hasattr(node, "meta") else None


def _shape(node) -> tuple[int, ...]:
    return tuple(int(s) for s in _val(node).shape)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def tensor_bytes(val) -> int:
    """Bytes of a fake tensor, or the sum over a tuple or list of them."""
    if isinstance(val, torch.Tensor):
        return _numel(val.shape) * val.element_size()
    if isinstance(val, (tuple, list)):
        return sum(tensor_bytes(v) for v in val)
    return 0


def node_bytes(node) -> int:
    return tensor_bytes(_val(node))


def input_nodes(node) -> list:
    """The nodes among ``node``'s arguments, in argument order (one entry
    per use, as ``hlo_analysis._operands`` lists an operand per use)."""
    out = []

    def walk(a):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)
    walk(node.args)
    walk(node.kwargs)
    return out


def is_source(node) -> bool:
    if node.op in ("placeholder", "get_attr"):
        return True
    return node.op == "call_function" and not input_nodes(node)


def is_transparent(node) -> bool:
    if node.op != "call_function":
        return False
    if node.target is operator.getitem:
        return True
    name = _op_name(node)
    if name.startswith("_assert") or name in ("detach", "detach_", "alias", "wait_tensor",
                                              "_wrap_tensor_autograd"):
        return True
    if not isinstance(node.target, torch._ops.OpOverload) or name in _ALSO_POINTWISE:
        return False
    schema = node.target._schema
    aliased = any(r.alias_info is not None and not r.alias_info.is_write
                  for r in schema.returns)
    writes = any(a.alias_info is not None and a.alias_info.is_write
                 for a in schema.arguments)
    return aliased and not writes


def is_task(node) -> bool:
    return (node.op == "call_function" and not is_source(node)
            and not is_transparent(node))


def is_pointwise(node) -> bool:
    if node.op != "call_function":
        return False
    if _op_name(node) in _ALSO_POINTWISE:
        return True
    return isinstance(node.target, torch._ops.OpOverload) and \
        torch.Tag.pointwise in node.target.tags


def collective_kind(node) -> str | None:
    """The HLO kind of a ``_c10d_functional`` collective node, else None."""
    if node.op != "call_function" or not isinstance(node.target, torch._ops.OpOverload):
        return None
    if not node.target._schema.name.startswith("_c10d_functional"):
        return None
    return COLLECTIVES.get(_op_name(node))


def collective_group_size(node) -> int:
    """The ranks a collective node runs over (its process group's size)."""
    name = _op_name(node)
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(node.args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(node.args[-1]).size()


def collective_bytes(node) -> int:
    """A collective's payload: its input's bytes."""
    return node_bytes(node.args[0])


def _einsum_flops(equation: str, shapes: list[tuple[int, ...]]) -> int:
    """2 * the product of every index size of an einsum (an ellipsis
    counts as the broadcast of the dims it stands for)."""
    lhs = equation.replace(" ", "").split("->")[0]
    sizes: dict[str, int] = {}
    ell: tuple[int, ...] = ()
    for term, shape in zip(lhs.split(","), shapes):
        if "..." in term:
            head, tail = term.split("...")
            n_ell = len(shape) - len(head) - len(tail)
            e = shape[len(head):len(head) + n_ell]
            ell = e if len(e) > len(ell) else ell
            letters = list(head) + [None] * n_ell + list(tail)
        else:
            letters = list(term)
        for c, s in zip(letters, shape):
            if c is not None:
                sizes[c] = max(sizes.get(c, 1), int(s))
    return 2 * _numel(sizes.values()) * _numel(ell)


def node_flops(node) -> int:
    """FLOPs of one node (see the module docstring); 0 for anything that
    is not a matrix product, an einsum or a convolution."""
    if node.op != "call_function" or _val(node) is None:
        return 0
    name = _op_name(node)
    if name in _MATMULS:
        a = node.args[1] if name in ("addmm", "baddbmm") else node.args[0]
        k = _shape(a)[-1]
        return 2 * _numel(_shape(node)) * k
    if name == "einsum":
        eq, operands = node.args[0], node.args[1]
        return _einsum_flops(eq, [_shape(o) for o in operands])
    if name in _CONVS:
        return 2 * _numel(_shape(node))
    return 0


def node_trips(node) -> int:
    """How many times ``node`` runs: its loop region's trips, else 1."""
    return node.meta.get("trips", 1)


def total_flops(graph: torch.fx.Graph) -> float:
    """The FLOPs of every task of ``graph`` (``hlo_analysis.analyze_hlo``'s
    ``flops`` term), each times its trips."""
    return float(sum(node_flops(n) * node_trips(n) for n in graph.nodes if is_task(n)))


def collective_totals(graph: torch.fx.Graph) -> tuple[dict, dict]:
    """({kind: payload bytes}, {kind: count}) over the graph's collectives,
    as ``analyze_hlo``'s ``collective_bytes`` and ``num_collectives``; a
    collective in a loop region counts once per trip."""
    nbytes: dict[str, float] = {}
    count: dict[str, int] = {}
    for n in graph.nodes:
        kind = collective_kind(n)
        if kind is not None:
            trips = node_trips(n)
            nbytes[kind] = nbytes.get(kind, 0.0) + float(collective_bytes(n)) * trips
            count[kind] = count.get(kind, 0) + trips
    return nbytes, count


def peak_live_bytes(graph: torch.fx.Graph, inputs: int = 0) -> int:
    """The most bytes live at once when the graph's nodes run in order: the
    ``inputs`` bytes (the step's arguments) throughout, a node's output
    from its node to its last use (the graph's outputs to the end); views
    and other transparent nodes own nothing. It is not a compiler's buffer
    assignment: no reuse, no in-place planning beyond what the graph holds."""
    nodes = list(graph.nodes)
    last = {}
    for i, n in enumerate(nodes):
        for a in input_nodes(n):
            last[a] = i
    live = peak = int(inputs)
    ends: dict[int, int] = {}
    for i, n in enumerate(nodes):
        if n.op == "call_function" and not is_transparent(n) and not _writes_in_place(n):
            b = node_bytes(n)
            live += b
            end = len(nodes) if any(u.op == "output" for u in n.users) else last.get(n, i)
            ends[end] = ends.get(end, 0) + b
        peak = max(peak, live)
        live -= ends.pop(i, 0)
    return int(peak)


def _writes_in_place(node) -> bool:
    """True for an op whose result is one of its inputs, written (``add_``,
    ``copy_``...): it owns no storage of its own."""
    if not isinstance(node.target, torch._ops.OpOverload):
        return False
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in node.target._schema.returns)


def _sequence_nr() -> int:
    """The autograd sequence number the next node of this thread gets
    (nodes are numbered in the order they are made)."""
    with torch.enable_grad():
        leaf = torch.zeros((), requires_grad=True)
        return (leaf * 1).grad_fn._sequence_nr() + 1


class _ScanIn(torch.autograd.Function):
    """The rows of ``xs`` (along ``dim``) that the recorded iterations read:
    the first, the middle and the last ``chunk``. Backward stacks their
    gradients into ``xs``'s, the middle's once per trip: the one ``stack``
    that the backward of ``xs.unbind(dim)`` makes when every row runs."""

    @staticmethod
    def forward(ctx, xs, dim, trips, c):
        ctx.dim, ctx.trips, ctx.c = dim, trips, c
        S = xs.shape[dim]
        return tuple(xs.select(dim, i) for i in [*range(2 * c), *range(S - c, S)])

    @staticmethod
    def backward(ctx, *grads):
        c = ctx.c
        every = [*grads[:c], *grads[c:2 * c] * (ctx.trips - 2), *grads[2 * c:]]
        return torch.stack(every, ctx.dim), None, None, None


class _ScanOut(torch.autograd.Function):
    """The scan's per-step outputs stacked along ``dim`` as every
    iteration's would be (the middle iteration's once per trip: one
    ``stack``, as when every step runs). Backward hands each recorded step
    its row of the gradient (the views of ``unbind``)."""

    @staticmethod
    def forward(ctx, dim, trips, c, *outs):
        ctx.dim, ctx.c = dim, c
        return torch.stack([*outs[:c], *outs[c:2 * c] * (trips - 2), *outs[2 * c:]], dim)

    @staticmethod
    def backward(ctx, g):
        rows, c = g.unbind(ctx.dim), ctx.c
        return None, None, None, *rows[:2 * c], *rows[len(rows) - c:]


class LocalRecorder(TorchDispatchMode):
    """Records the LOCAL ATen ops (and ``_c10d_functional`` collectives)
    that a step on DTensors runs on one rank into a ``torch.fx.Graph``.

    Under this mode an op on DTensors is declined (``NotImplemented``), so
    DTensor dispatches it as it would, and the local ops it runs on the
    shards come back here and are recorded: one ``call_function`` node per
    op that touches a meta tensor (the shards of a dry-run are meta; the
    host-side tensor ops of DTensor's own planning, and the fake tensors it
    runs an op on the first time it plans it, are not the program),
    with the result as ``meta["val"]``. A tensor first seen as an argument
    becomes a placeholder; an in-place op's result is its node from then
    on. Unlike ``make_fx`` it keeps DTensor's sharding-propagation cache
    on, so a full-width step records in seconds.

    A model's time scan (the sLSTM's) asks the recorder for a loop region
    (``scan``) and records three of its iterations, the middle one with
    the trips of all the iterations between the first and the last
    (``scan_regions=False`` records every iteration, as the step runs).
    ``loops`` lists the trip count of each loop recorded as a region, in
    the order they run: each forward (a remat's recompute included) and
    each backward, as XLA's ``while`` loops of a scan and of its
    gradient."""

    def __init__(self, scan_regions: bool = True):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary
        self.graph = torch.fx.Graph()
        self._node = WeakIdKeyDictionary()
        self._inputs = 0
        self.scan_regions = scan_regions
        self.loops: list[int] = []
        self._trips = 1                  # the forward ops recorded now run this often
        # [first, end) autograd sequence numbers of a region's nodes, their
        # trips and the loop's: their backward ops run as often
        self._regions: list[tuple[int, int, int, int]] = []
        self._backward_seen: set[int] = set()

    def scan(self, body, carry, xs, dim: int, chunk: int):
        """``body(carry, rows) -> (carry, outs)`` over ``xs`` cut along
        ``dim`` into iterations of ``chunk`` rows (``rows``: ``chunk``
        slices; ``outs``: one tensor per row). Returns ``(carry, y)``,
        ``y`` the outs stacked along ``dim``, as the plain loop gives them.

        The first and the last iteration are recorded as they run; the
        middle one stands for the trips - 2 between them: its ops, and
        (through autograd's sequence numbers) their backward ops, carry
        ``meta["trips"]``. So the record counts what every iteration
        would, backward and remat included, from three iterations' ops."""
        trips = xs.shape[dim] // chunk
        self.loops.append(trips)
        rows = _ScanIn.apply(xs, dim, trips, chunk)
        carry, first = body(carry, rows[:chunk])
        lo, self._trips = _sequence_nr(), trips - 2
        try:
            carry, middle = body(carry, rows[chunk:2 * chunk])
        finally:
            self._trips = 1
        self._regions.append((lo, _sequence_nr(), trips - 2, trips))
        carry, last = body(carry, rows[2 * chunk:])
        return carry, _ScanOut.apply(dim, trips, chunk, *first, *middle, *last)

    def _op_trips(self) -> int:
        """The trips of the op being recorded: the region's forward, or a
        backward op of a node that a region made."""
        if self._trips != 1 or not self._regions or torch.is_grad_enabled():
            return self._trips
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        for i, (lo, end, trips, loop) in enumerate(self._regions):
            if lo <= seq < end:
                if i not in self._backward_seen:
                    self._backward_seen.add(i)
                    self.loops.append(loop)
                return trips
        return 1

    def _arg(self, a):
        if not isinstance(a, torch.Tensor):
            return a
        nd = self._node.get(a)
        if isinstance(nd, tuple):     # an item of a tuple result, first used now
            nd = self.graph.call_function(operator.getitem, nd)
            nd.meta["val"] = a
            self._node[a] = nd
        if nd is None:
            nd = self.graph.placeholder(f"in{self._inputs}")
            self._inputs += 1
            nd.meta["val"] = a
            self._node[a] = nd
        return nd

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten, tree_map
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        outs, _ = tree_flatten(out)
        if not any(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   for t in flat + outs) or any(isinstance(t, FakeTensor) for t in flat):
            return out
        nd = self.graph.call_function(func, tree_map(self._arg, args),
                                      tree_map(self._arg, kwargs))
        nd.meta["val"] = out
        trips = self._op_trips()
        if trips != 1:
            nd.meta["trips"] = trips
        if isinstance(out, torch.Tensor):
            self._node[out] = nd
        elif isinstance(out, (tuple, list)):   # items get a getitem node when used
            for i, t in enumerate(out):
                if isinstance(t, torch.Tensor):
                    self._node[t] = (nd, i)
        return out

    def finish(self, result) -> torch.fx.Graph:
        """Close the graph with ``result`` (local tensors, or DTensors whose
        shards are taken) as its output, and return it."""
        from torch.utils._pytree import tree_map

        def local(t):
            if isinstance(t, torch.Tensor) and hasattr(t, "to_local"):
                t = t._local_tensor
            return self._arg(t) if isinstance(t, torch.Tensor) else t
        self.graph.output(tree_map(local, result))
        return self.graph
