"""Optimized-HLO text analyzer for the roofline terms (the port's own copy).

The JAX package's ``launch/hlo_analysis.py`` is pure host Python; the port
keeps this copy of it, regexes byte for byte, so that it imports nothing of
that package. The text is produced where JAX runs (a ``Compiled`` object's
``as_text()``); parsing it needs neither JAX nor a device.

``compiled.cost_analysis()`` on this JAX/XLA reports per-device FLOPs with
`while` bodies counted ONCE (verified empirically — see DESIGN.md §7), so we
re-derive everything from ``compiled.as_text()``:

* computations are parsed into blocks with per-op output shapes;
* `while` ops get trip counts from caller-supplied hints (the dry-run knows
  every scan length statically); multipliers propagate through the call
  graph (nested scans multiply);
* FLOPs: recomputed from `dot`/`convolution` shapes (2 * numel(out) * K) —
  elementwise FLOPs are <1% for these models and are reported separately
  from cost_analysis for cross-checking;
* collective bytes: operand bytes of all-reduce / all-gather /
  reduce-scatter / all-to-all / collective-permute, trip-scaled;
* HBM bytes: fusion-aware — instruction-level ops read operands + write
  outputs; fusion-body computations are excluded (their fusion op accounts
  for them).

Everything is PER DEVICE (the HLO is the post-SPMD per-device program).
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^)]*\)|[\w\[\],{}\s]+?)\s+([\w\-]+)\(")
_CALLED_RE = re.compile(r"(?:calls=|to_apply=|condition=|body=)%?([\w.\-]+)")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->\s*.+\s*\{")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_numel(type_str: str) -> int:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return 0
    n = 1
    for d in m.group(2).split(","):
        if d:
            n *= int(d)
    return n


@dataclasses.dataclass
class Op:
    name: str
    type_str: str
    kind: str
    line: str


@dataclasses.dataclass
class Computation:
    name: str
    ops: list[Op]
    is_entry: bool


def parse_computations(hlo: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    for line in hlo.splitlines():
        hdr = _COMP_HDR_RE.match(line.strip())
        if hdr and ("->" in line) and line.strip().endswith("{"):
            cur = Computation(hdr.group(1), [], line.lstrip().startswith("ENTRY"))
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _OP_RE.match(line)
        if m:
            cur.ops.append(Op(m.group(1), m.group(2), m.group(3), line))
    return comps


def _operands(op: Op) -> list[str]:
    """Operand names: the parenthesized list right after the op kind.

    Depending on the XLA version the operands appear bare (``%name``) or
    with their type inlined (``f32[128,256]{1,0} %name``) — the name is
    always the last whitespace-separated token.
    """
    m = re.search(re.escape(op.kind) + r"\(([^)]*)\)", op.line)
    if not m:
        return []
    # split on commas at bracket depth 0 only — inlined operand types carry
    # commas of their own (f32[128,256]{1,0})
    pieces, cur, depth = [], [], 0
    for ch in m.group(1):
        if ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        if ch == "," and depth == 0:
            pieces.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        pieces.append("".join(cur))
    out = []
    for o in pieces:
        toks = o.strip().split()
        if toks:
            out.append(toks[-1].lstrip("%"))
    return out


def _dot_flops(op: Op, shapes: dict[str, str]) -> int:
    """2 * numel(out) * K, K = product of lhs contracting dim sizes."""
    out_n = _shape_numel(op.type_str)
    operands = _operands(op)
    lhs_type = shapes.get(operands[0], "") if operands else ""
    dims_m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.line)
    if not dims_m or not lhs_type:
        return 2 * out_n  # degenerate
    lhs_dims_m = _SHAPE_RE.search(lhs_type)
    if not lhs_dims_m:
        return 2 * out_n
    lhs_shape = [int(d) for d in lhs_dims_m.group(2).split(",") if d]
    K = 1
    for ci in dims_m.group(1).split(","):
        if ci:
            K *= lhs_shape[int(ci)]
    return 2 * out_n * K


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def _fusion_bytes(op: "Op", comps: dict) -> float:
    """Traffic of a fusion op. Loop-carry updates are fused
    dynamic-update-slices whose OUTPUT is the whole carry buffer but whose
    real (TPU, in-place) traffic is just the updated slice — detect
    DUS-rooted fusions (incl. tuple roots) and charge the slice only."""
    bodies = _CALLED_RE.findall(op.line)
    body = comps.get(bodies[0]) if bodies else None
    if body is None or not body.ops:
        return 2 * _shape_bytes(op.type_str)
    shapes = {o.name: o.type_str for o in body.ops}
    kinds = {o.name: o.kind for o in body.ops}
    root = body.ops[-1]

    def elem_bytes(name: str, fallback_type: str) -> float:
        if kinds.get(name) == "dynamic-update-slice":
            dus = next(o for o in body.ops if o.name == name)
            ops_ = _operands(dus)
            upd = shapes.get(ops_[1], "") if len(ops_) > 1 else ""
            return 2 * _shape_bytes(upd)
        return 2 * _shape_bytes(shapes.get(name, fallback_type))

    if root.kind == "dynamic-update-slice":
        return elem_bytes(root.name, root.type_str)
    if root.kind == "tuple":
        return sum(elem_bytes(o, "") for o in _operands(root))
    return 2 * _shape_bytes(op.type_str)

_MEM_SKIP = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "while", "conditional", "call", "after-all", "partition-id", "replica-id",
}


def fusion_body_set(comps: dict[str, Computation]) -> set[str]:
    """Computations called by a ``fusion`` op (accounted via the op)."""
    fusion_bodies: set[str] = set()
    for c in comps.values():
        for op in c.ops:
            if op.kind == "fusion":
                for called in _CALLED_RE.findall(op.line):
                    fusion_bodies.add(called)
    return fusion_bodies


def call_multipliers(comps: dict[str, Computation], entry_name: str,
                     fusion_bodies: set[str],
                     trip_hints: list[int] | None = None,
                     ) -> tuple[dict[str, float], list[int], int]:
    """Execution-count multipliers per computation, via DFS over the call
    graph. `while` ops consume ``trip_hints`` in DFS (nesting) order; when
    the hints run out, the LAST hint is reused (1 with no hints at all).

    Returns ``(mult, trips_used, hints_needed)`` where ``hints_needed`` is
    the number of `while` visits — callers compare it against
    ``len(trip_hints)`` to detect the shortfall (``Analysis.hints_exhausted``).
    """
    hints = list(trip_hints or [])
    hint_i = 0
    mult: dict[str, float] = defaultdict(float)
    trips_used: list[int] = []

    def visit(name: str, m: float):
        nonlocal hint_i
        if name not in comps:
            return
        mult[name] += m
        for op in comps[name].ops:
            if op.kind == "while":
                body_cond = _CALLED_RE.findall(op.line)
                if hints:
                    trip = hints[min(hint_i, len(hints) - 1)]
                else:
                    trip = 1
                hint_i += 1
                trips_used.append(trip)
                for callee in body_cond:
                    visit(callee, m * trip)
            elif op.kind in ("fusion",):
                continue  # body accounted via the fusion op itself
            elif op.kind in ("call", "conditional", "custom-call", "map",
                             "reduce", "sort", "scatter", "select-and-scatter",
                             "reduce-window", "all-reduce", "reduce-scatter"):
                for callee in _CALLED_RE.findall(op.line):
                    if callee in comps and callee not in fusion_bodies:
                        visit(callee, m)

    visit(entry_name, 1.0)
    return dict(mult), trips_used, hint_i


@dataclasses.dataclass
class Analysis:
    flops: float                     # per-device, trip-scaled (dots+convs)
    collective_bytes: dict[str, float]  # per kind, per-device, trip-scaled
    hbm_bytes: float                 # fusion-aware per-device traffic
    num_collectives: dict[str, int]
    while_trips: list[int]
    # trip-hint accounting: the DFS needed more hints than it was given
    # (the last hint was reused for the excess `while` ops — a guess).
    hints_exhausted: bool = False
    while_hints_needed: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def analyze_hlo(hlo: str, trip_hints: list[int] | None = None) -> Analysis:
    comps = parse_computations(hlo)
    entry = next((c for c in comps.values() if c.is_entry), None)
    if entry is None:
        raise ValueError("no ENTRY computation found")

    fusion_bodies = fusion_body_set(comps)
    hints = list(trip_hints or [])
    mult, trips_used, hints_needed = call_multipliers(
        comps, entry.name, fusion_bodies, hints)
    hints_exhausted = hints_needed > len(hints) and hints_needed > 0
    if hints and hints_exhausted:
        # warn once per analyze call (not per while op): silent reuse of the
        # last hint is a guess the caller should know about.
        warnings.warn(
            f"analyze_hlo: {hints_needed} `while` ops but only {len(hints)} "
            f"trip hint(s); reusing the last hint for the remainder "
            f"(trip-scaled terms are a guess past hint "
            f"#{len(hints)})", stacklevel=2)

    shapes_by_comp: dict[str, dict[str, str]] = {
        cname: {op.name: op.type_str for op in c.ops} for cname, c in comps.items()
    }

    flops = 0.0
    coll_bytes: dict[str, float] = defaultdict(float)
    coll_count: dict[str, int] = defaultdict(int)
    hbm = 0.0

    for cname, c in comps.items():
        m = mult.get(cname, 0.0)
        if m == 0.0 or cname in fusion_bodies:
            # fused dots still execute: count dot flops inside fusion bodies
            # at the multiplier of their call sites.
            if cname in fusion_bodies:
                pass
            else:
                continue
        shapes = shapes_by_comp[cname]
        for op in c.ops:
            if op.kind == "dot":
                flops += m * _dot_flops(op, shapes)
            elif op.kind == "convolution":
                flops += m * 2 * _shape_numel(op.type_str) * 1  # lower bound
            if cname in fusion_bodies:
                continue  # only flops counted inside fusion bodies
            if op.kind in _COLLECTIVES:
                b = sum(_shape_bytes(shapes.get(o, "")) for o in _operands(op))
                if b == 0:
                    b = _shape_bytes(op.type_str)
                coll_bytes[op.kind] += m * b
                coll_count[op.kind] += 1
            if op.kind not in _MEM_SKIP and op.kind not in _COLLECTIVES:
                if op.kind == "fusion":
                    hbm += m * _fusion_bytes(op, comps)
                elif op.kind in ("dot", "convolution"):
                    # matmuls: stream operands from HBM + write output
                    rb = sum(_shape_bytes(shapes.get(o, "")) for o in _operands(op))
                    hbm += m * (rb + _shape_bytes(op.type_str))
                elif op.kind == "dynamic-update-slice":
                    # in-place aliased on TPU: traffic is the UPDATE slice,
                    # not the whole buffer (critical inside while carries)
                    operands = _operands(op)
                    upd = shapes.get(operands[1], "") if len(operands) > 1 else ""
                    hbm += m * 2 * _shape_bytes(upd)
                elif op.kind == "dynamic-slice":
                    hbm += m * 2 * _shape_bytes(op.type_str)
                elif op.kind == "copy":
                    pass  # while-carry copies alias on TPU
                else:
                    # perfect-fusion model: every intermediate written once
                    # and read once by its consumer(s) — this is what a TPU
                    # fusion pipeline achieves; counting operands per op on
                    # CPU-compiled (barely fused) HLO overstates traffic ~10x.
                    hbm += m * 2 * _shape_bytes(op.type_str)

    # fusion-body dot flops: attribute at the caller's multiplier
    for cname in fusion_bodies:
        if cname not in comps:
            continue
        callers = 0.0
        for on, c in comps.items():
            mm = mult.get(on, 0.0)
            if mm == 0.0:
                continue
            for op in c.ops:
                if op.kind == "fusion" and cname in _CALLED_RE.findall(op.line):
                    callers += mm
        if callers == 0.0:
            continue
        shapes = shapes_by_comp[cname]
        for op in comps[cname].ops:
            if op.kind == "dot":
                flops += callers * _dot_flops(op, shapes)

    return Analysis(
        flops=flops,
        collective_bytes=dict(coll_bytes),
        hbm_bytes=hbm,
        num_collectives=dict(coll_count),
        while_trips=trips_used,
        hints_exhausted=hints_exhausted,
        while_hints_needed=hints_needed,
    )
