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
"""
from __future__ import annotations

import operator

import torch

_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "matmul")
_CONVS = ("convolution", "conv1d", "conv2d", "_convolution")
# casts and masks are elementwise too, but carry no pointwise tag
_ALSO_POINTWISE = ("to", "_to_copy", "type_as", "where", "__and__", "__or__",
                   "bitwise_and", "bitwise_or", "logical_and", "logical_or",
                   "logical_not", "masked_fill", "clone")


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
    if name.startswith("_assert") or name in ("detach", "detach_", "alias"):
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


def total_flops(graph: torch.fx.Graph) -> float:
    """The FLOPs of every task of ``graph`` (``hlo_analysis.analyze_hlo``'s
    ``flops`` term)."""
    return float(sum(node_flops(n) for n in graph.nodes if is_task(n)))
