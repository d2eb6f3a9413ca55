"""HLO → weighted task graph: the per-op communication-graph extractor.

``launch/hlo_analysis.py`` reduces an optimized HLO module to scalar
roofline totals. This module keeps the STRUCTURE: every executed op (or
fused group) becomes a task, every producer→consumer dataflow becomes a
weighted edge, and the result is a :class:`~repro.core.taskgraph.TaskGraph`
ready for ``shared_map`` — the paper's premise ("the communication pattern
is sparse and can be determined in advance") applied to the model zoo this
repo carries.

Graph construction (``extract_comm_graph``):

* **Tasks** — one per op of every computation the entry actually reaches
  (fusion bodies collapse into their fusion op at the default ``fused``
  granularity; ``op`` granularity expands them). Pure data-plumbing ops
  (parameter/constant/tuple/get-tuple-element/bitcast/copy) are
  TRANSPARENT: they are not tasks, and dataflow through them is followed
  to the real producer, so e.g. ``A -> tuple -> GTE -> B`` yields the edge
  ``A — B``.
* **Edge weights** — bytes of the consumed operand type, scaled by the
  computation's execution-count multiplier (the `while`-trip DFS shared
  with ``analyze_hlo``). A consumer whose operand resolves through a tuple
  to several producers splits the bytes evenly. Call boundaries (`while` /
  `call` / `conditional` / fusion ops and their callee's root) contribute
  the op's output bytes at the CALLEE's multiplier, keeping the graph
  connected across computations.
* **Collectives** — their payload re-crosses the network: operand bytes ×
  multiplier, distributed over the participating shards of the op's
  ``replica_groups`` (per-shard share = payload / group size), are added
  on top of the dataflow weight of the collective's in-edges.
* **Vertex weights** — per-op FLOPs (``_dot_flops`` for dots, 2·numel for
  convolutions; a fused group sums its body's dots), trip-scaled, floored
  at 1 so load balance over FLOP-free tasks still means "tasks per PE".

The text comes from wherever JAX compiled the program (a ``Compiled``
object's ``as_text()``); extraction is host Python and needs neither JAX nor
a device. The reference's ``compile_model_cell`` and ``model_comm_graph``,
which compile a cell of the model zoo, wait for the port's own model front
end (ROADMAP.md, Queue 1, item 8); ``tests/data/hlo/make_hlo_fixtures.py``
writes two such texts with the JAX package.
"""
from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

from ..core.taskgraph import TaskGraph
from .hlo_analysis import (_COLLECTIVES, _CALLED_RE, _dot_flops,
                           _operands, _shape_bytes, _shape_numel,
                           Computation, Op, call_multipliers,
                           fusion_body_set, parse_computations)

# dataflow-transparent kinds: never tasks; edges pass through them
_TRANSPARENT = ("get-tuple-element", "tuple", "bitcast", "copy",
                "optimization-barrier")
# source kinds: never tasks; dataflow resolution stops at them
_SOURCES = ("parameter", "constant", "after-all", "partition-id",
            "replica-id")
# call-carrying kinds whose callee subgraphs join the task graph
_CALLERS = ("while", "call", "conditional")

_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]*)\}")


def _group_size(op: Op) -> int:
    """Participating-shard count of a collective: size of the first replica
    group (groups are uniform in SPMD HLO); 1 when unannotated."""
    m = _GROUPS_RE.search(op.line)
    if not m:
        return 1
    return max(len([d for d in m.group(1).split(",") if d]), 1)


def _op_flops(op: Op, shapes: dict[str, str],
              comps: dict[str, Computation],
              fused: bool) -> float:
    """Compute load of one task. ``fused``: a fusion op absorbs its body's
    dot FLOPs (the body's other elementwise work is <1% for these models,
    same approximation as analyze_hlo)."""
    if op.kind == "dot":
        return float(_dot_flops(op, shapes))
    if op.kind == "convolution":
        return float(2 * _shape_numel(op.type_str))
    if op.kind == "fusion" and fused:
        total = 0.0
        for body_name in _CALLED_RE.findall(op.line):
            body = comps.get(body_name)
            if body is None:
                continue
            body_shapes = {o.name: o.type_str for o in body.ops}
            for bop in body.ops:
                if bop.kind == "dot":
                    total += float(_dot_flops(bop, body_shapes))
                elif bop.kind == "convolution":
                    total += float(2 * _shape_numel(bop.type_str))
        return total
    return 0.0


def extract_comm_graph(compiled_or_hlo, trip_hints: list[int] | None = None,
                       *, granularity: str = "fused",
                       min_tasks: int | None = None,
                       meta: dict | None = None) -> TaskGraph:
    """Extract the per-op communication graph of a compiled module.

    Parameters
    ----------
    compiled_or_hlo: the optimized-HLO text, or anything with
        ``as_text()`` that returns it (a compiled program).
    trip_hints: `while` trip counts in nesting order (see
        ``analyze_hlo``); scales edge/vertex weights of loop bodies.
    granularity: ``"fused"`` (default — one task per fusion op, the
        shape XLA actually executes) or ``"op"`` (fusion bodies expand
        into per-op tasks — finer, larger graphs).
    min_tasks: with ``granularity="fused"``, re-extract at ``"op"``
        granularity when the fused graph has fewer tasks than this —
        mapping onto k PEs needs n >= k.
    """
    if granularity not in ("fused", "op"):
        raise ValueError(f"granularity must be 'fused' or 'op', "
                         f"got {granularity!r}")
    hlo = compiled_or_hlo if isinstance(compiled_or_hlo, str) \
        else compiled_or_hlo.as_text()
    comps = parse_computations(hlo)
    entry = next((c for c in comps.values() if c.is_entry), None)
    if entry is None:
        raise ValueError("no ENTRY computation found")
    fusion_bodies = fusion_body_set(comps)
    hints = list(trip_hints or [])
    mult, trips_used, hints_needed = call_multipliers(
        comps, entry.name, fusion_bodies, hints)

    tg = _build(comps, entry, fusion_bodies, mult, granularity)
    if (granularity == "fused" and min_tasks is not None
            and tg.n < int(min_tasks)):
        granularity = "op"
        tg = _build(comps, entry, fusion_bodies, mult, granularity)
    tg.meta.update(meta or {})
    tg.meta.update({
        "source": "hlo",
        "entry": entry.name,
        "granularity": granularity,
        "while_trips": list(trips_used),
        "hints_exhausted": hints_needed > len(hints) and hints_needed > 0,
    })
    return tg


def _build(comps: dict[str, Computation], entry: Computation,
           fusion_bodies: set[str], mult: dict[str, float],
           granularity: str) -> TaskGraph:
    fused = granularity == "fused"

    # fusion bodies run at the summed multiplier of their call sites (the
    # DFS skips them); needed for op-granularity tasks and boundary edges.
    body_mult: dict[str, float] = defaultdict(float)
    for cname, c in comps.items():
        m = mult.get(cname, 0.0)
        if m == 0.0:
            continue
        for op in c.ops:
            if op.kind == "fusion":
                for callee in _CALLED_RE.findall(op.line):
                    body_mult[callee] += m

    def comp_mult(cname: str) -> float:
        if cname in fusion_bodies:
            return 0.0 if fused else body_mult.get(cname, 0.0)
        return mult.get(cname, 0.0)

    included = [c for c in comps.values() if comp_mult(c.name) > 0.0]

    # task ids in parse order (deterministic for a given HLO text)
    task_id: dict[tuple[str, str], int] = {}
    vwgt: list[float] = []
    ops_by_name: dict[str, dict[str, Op]] = {}
    shapes_by_comp: dict[str, dict[str, str]] = {}
    for c in included:
        ops_by_name[c.name] = {op.name: op for op in c.ops}
        shapes_by_comp[c.name] = {op.name: op.type_str for op in c.ops}
        m = comp_mult(c.name)
        for op in c.ops:
            if op.kind in _TRANSPARENT or op.kind in _SOURCES:
                continue
            task_id[(c.name, op.name)] = len(vwgt)
            vwgt.append(max(m * _op_flops(op, shapes_by_comp[c.name],
                                          comps, fused), 1.0))

    edges: dict[tuple[int, int], float] = defaultdict(float)

    def add_edge(a: int, b: int, w: float) -> None:
        if a == b or w <= 0.0:
            return
        edges[(a, b) if a < b else (b, a)] += w

    def resolve(cname: str, name: str, _seen: set | None = None) -> list[int]:
        """Task ids producing value ``name`` inside computation ``cname``,
        following through transparent ops (tuple fan-in included)."""
        tid = task_id.get((cname, name))
        if tid is not None:
            return [tid]
        op = ops_by_name[cname].get(name)
        if op is None or op.kind in _SOURCES:
            return []
        seen = _seen or set()
        if name in seen:
            return []
        seen.add(name)
        out: list[int] = []
        for o in _operands(op):
            out.extend(resolve(cname, o, seen))
        return out

    for c in included:
        m = comp_mult(c.name)
        shapes = shapes_by_comp[c.name]
        for op in c.ops:
            tid = task_id.get((c.name, op.name))
            if tid is None:
                continue
            # dataflow in-edges: operand bytes from each resolved producer
            coll_share = 0.0
            if op.kind in _COLLECTIVES:
                payload = sum(_shape_bytes(shapes.get(o, ""))
                              for o in _operands(op))
                if payload == 0:
                    payload = _shape_bytes(op.type_str)
                coll_share = m * payload / _group_size(op)
            for o in _operands(op):
                producers = resolve(c.name, o)
                if not producers:
                    continue
                b = _shape_bytes(shapes.get(o, ""))
                if b == 0:  # operand shape unrecorded: fall back to output
                    b = _shape_bytes(op.type_str)
                per = (m * b + coll_share) / len(producers)
                for p in producers:
                    add_edge(p, tid, per)
            # call-boundary edges: the callee's root feeds this op's output
            # back across the boundary once per callee execution.
            callees = ()
            if op.kind in _CALLERS or (op.kind == "fusion" and not fused):
                callees = _CALLED_RE.findall(op.line)
            for callee in callees:
                body = comps.get(callee)
                if body is None or callee not in ops_by_name or not body.ops:
                    continue
                cm = comp_mult(callee)
                if cm <= 0.0:
                    continue
                w = cm * _shape_bytes(op.type_str)
                roots = resolve(callee, body.ops[-1].name)
                for p in roots:
                    add_edge(p, tid, w / len(roots))

    n = len(vwgt)
    if n == 0:
        raise ValueError("extracted task graph is empty (no executable ops)")
    if edges:
        uv = np.array(list(edges.keys()), np.int64)
        w = np.array(list(edges.values()), np.float64)
        u, v = uv[:, 0], uv[:, 1]
    else:
        u = v = np.zeros(0, np.int64)
        w = np.zeros(0, np.float64)
    return TaskGraph.from_edges(n, u, v, w, vwgt=np.asarray(vwgt))


def default_placement(n: int, k: int) -> np.ndarray:
    """The no-mapper baseline: tasks in program order, chunked onto PEs in
    default (hierarchy-aligned) order — what a launcher that ignores the
    communication pattern does. The closed-loop comparisons measure
    ``shared_map`` against this."""
    return (np.arange(int(n), dtype=np.int64) * int(k)) // max(int(n), 1)
