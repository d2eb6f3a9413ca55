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
a device. ``tests/data/hlo/make_hlo_fixtures.py`` writes two such texts
with the JAX package.

The port's own models (``compile_model_cell``, ``model_comm_graph``) take
another front end: ``torch.export`` of the port's training loss on
``input_specs``' meta tensors, with the params built on the meta device, so
nothing is materialized (``export_train_cell``); ``extract_fx_graph`` turns
the exported graph into a ``TaskGraph`` by the rules above, with the node
kinds, FLOPs and bytes of ``launch/fx_analysis.py``:

* **Tasks** — one per call node that is neither a source (placeholder,
  constant, factory) nor transparent (views, ``getitem``, checks); edges
  carry the consumed tensor's bytes from each resolved producer, vertex
  weights the node's FLOPs floored at 1.
* **``fused``** — eager PyTorch has no compiler fusion, so ``fused`` is a
  stated, deterministic coarsening after XLA's loop fusion: walking the
  graph from its end, a pointwise task (``fx_analysis.is_pointwise``) whose
  value reaches exactly one task merges into that task's group; a group
  sums its members' FLOPs, and edges inside a group vanish. A group's id
  is the graph position of its last node. ``op`` keeps one task per node.
* **Loops are unrolled** in the exported graph (the layer loop, the sLSTM
  time loop), so every op appears as often as it runs and the trip hints
  scale nothing; they ride in ``meta`` only.
* The graph is not the reference's HLO graph bit for bit (another IR, no
  compiler passes); its FLOP total is the same (whisper-tiny: equal to 4
  digits, ``tests/test_torch_model_graphs.py``).
* **Collectives** — a graph traced per rank on DTensors (``make_fx``,
  ``launch/dryrun.py``) holds ``_c10d_functional`` collectives: each is a
  task, ``wait_tensor`` is transparent, and the collective's payload
  divided by its group size is added on top of its in-edges' dataflow
  weight, as for the HLO's.
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


# ---------------------------------------------------------------------------
# the port's own models: torch.export front end
# ---------------------------------------------------------------------------

def export_train_cell(cfg, seq_len: int = 64, batch: int = 4):
    """``torch.export`` of the port's training loss of ``cfg`` on
    ``input_specs``' meta tensors, with every param on the meta device.

    The loss is traced as ``models.model.loss_fn`` with grad mode off, so
    no remat wrapper and no grad-mode switch hides the graph inside one
    higher-order node."""
    import torch

    from ..models import model as M
    from ..models.transformer import DecoderLM
    from ..models.whisper import EncDecLM

    class _LossCell(torch.nn.Module):
        def __init__(self, params):
            super().__init__()
            self.params = params

        def forward(self, b):
            return M.loss_fn(cfg, self.params, b)

    specs = M.input_specs(cfg, seq_len, batch, "train")
    params = (EncDecLM if cfg.is_encoder_decoder else DecoderLM)(cfg, device="meta")
    with torch.no_grad():
        return torch.export.export(_LossCell(params), (specs,), strict=False)


def compile_model_cell(arch: str, *, seq_len: int = 64, batch: int = 4,
                       mode: str = "train"):
    """Export one small single-device train cell of a ``configs/`` arch and
    return ``(exported, trip_hints)`` (a ``torch.export.ExportedProgram``;
    see ``export_train_cell``). Nothing is materialized; it runs on the
    host. Only ``mode="train"`` (the loss) is supported, as in the
    reference."""
    if mode != "train":
        raise ValueError("compile_model_cell supports mode='train' only, as the "
                         "reference's; launch/dryrun.py traces prefill and decode cells")
    from ..configs.registry import get_config
    from ..models import model as M

    cfg = get_config(arch)
    return export_train_cell(cfg, seq_len, batch), M.scan_trip_hints(cfg, seq_len, mode)


def model_comm_graph(arch: str, *, seq_len: int = 64, batch: int = 4,
                     granularity: str = "fused",
                     min_tasks: int | None = None) -> TaskGraph:
    """Export a tiny train cell of ``arch`` and extract its communication
    task graph (the reference's two-step quickstart in one call)."""
    exported, hints = compile_model_cell(arch, seq_len=seq_len, batch=batch)
    return extract_fx_graph(
        exported, granularity=granularity, min_tasks=min_tasks,
        meta={"arch": arch, "seq_len": seq_len, "batch": batch,
              "mode": "train", "trip_hints": hints})


def extract_fx_graph(exported, *, granularity: str = "fused",
                     min_tasks: int | None = None,
                     meta: dict | None = None) -> TaskGraph:
    """The communication graph of an ``ExportedProgram``, a ``GraphModule``
    or a ``torch.fx.Graph``; ``granularity`` and ``min_tasks`` as in
    ``extract_comm_graph`` (``fused`` is the loop-fusion coarsening of
    the module docstring)."""
    if granularity not in ("fused", "op"):
        raise ValueError(f"granularity must be 'fused' or 'op', "
                         f"got {granularity!r}")
    graph = getattr(exported, "graph", exported)
    tg = _build_fx(graph, granularity)
    if (granularity == "fused" and min_tasks is not None
            and tg.n < int(min_tasks)):
        granularity = "op"
        tg = _build_fx(graph, granularity)
    tg.meta.update(meta or {})
    tg.meta.update({"source": "export", "granularity": granularity})
    return tg


def _build_fx(graph, granularity: str) -> TaskGraph:
    from . import fx_analysis as FX

    nodes = list(graph.nodes)
    tasks = [nd for nd in nodes if FX.is_task(nd)]
    is_task = set(tasks)
    producers: dict = {}

    def resolve(nd) -> list:
        """Tasks producing ``nd``'s value, through transparent nodes."""
        if nd in is_task:
            return [nd]
        hit = producers.get(nd)
        if hit is None:
            hit = []
            if FX.is_transparent(nd):
                for i in FX.input_nodes(nd):
                    hit.extend(resolve(i))
            producers[nd] = hit
        return hit

    # groups: every task its own, or (fused) a pointwise task whose value
    # reaches one task only joins that task's group, from the end backwards
    group = {t: t for t in tasks}
    if granularity == "fused":
        def consumers(nd, out: set) -> set:
            for u in nd.users:
                if u in is_task or not FX.is_transparent(u):
                    out.add(u)
                else:
                    consumers(u, out)
            return out
        for t in reversed(tasks):
            if FX.is_pointwise(t):
                (c, *more) = consumers(t, set()) or (None,)
                if c is not None and not more and c in is_task:
                    group[t] = group[c]
    pos = {nd: i for i, nd in enumerate(nodes)}
    roots = sorted({group[t] for t in tasks}, key=pos.__getitem__)
    tid = {r: i for i, r in enumerate(roots)}
    vwgt = np.zeros(len(roots), np.float64)
    for t in tasks:
        vwgt[tid[group[t]]] += FX.node_flops(t) * FX.node_trips(t)
    vwgt = np.maximum(vwgt, 1.0)

    edges: dict[tuple[int, int], float] = defaultdict(float)
    for t in tasks:
        b = tid[group[t]]
        # a collective's payload re-crosses the network: its per-rank share
        # rides on top of its in-edges' dataflow weight; a loop region's
        # task reads its operands once per trip
        trips = FX.node_trips(t)
        share = 0.0
        if FX.collective_kind(t) is not None:
            share = FX.collective_bytes(t) / FX.collective_group_size(t)
        for i in FX.input_nodes(t):
            prods = resolve(i)
            if not prods:
                continue
            per = (FX.node_bytes(i) + share) * trips / len(prods)
            for p in prods:
                a = tid[group[p]]
                if a != b and per > 0.0:
                    edges[(a, b) if a < b else (b, a)] += per
    n = len(roots)
    if n == 0:
        raise ValueError("exported graph has no tasks")
    if edges:
        uv = np.array(list(edges.keys()), np.int64)
        u, v = uv[:, 0], uv[:, 1]
        w = np.array(list(edges.values()), np.float64)
    else:
        u = v = np.zeros(0, np.int64)
        w = np.zeros(0, np.float64)
    return TaskGraph.from_edges(n, u, v, w, vwgt=vwgt)
