"""HLO ingestion in the port (``repro_torch.launch.hlo_analysis``,
``repro_torch.launch.comm_graph``) against the JAX package on the CPU.

Every hand-written fixture of ``tests/test_hlo_fixtures.py``, a few programs
compiled here, and the two committed model fixtures (``tests/data/hlo/``)
go through both packages: the parsed computations and every ``Analysis``
field are equal, and the extracted ``TaskGraph``s are equal array for
array, ``meta`` included, with byte-identical fingerprints. The committed
fixtures also match their sidecars (so a stale sidecar fails here)."""
import dataclasses
import gzip
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch import comm_graph as JCG
from repro.launch import hlo_analysis as JA
from repro_torch.launch import comm_graph as TCG
from repro_torch.launch import hlo_analysis as TA
from test_hlo_fixtures import COLLECTIVE_HLO, FUSION_HLO, NESTED_HLO, WHILE_HLO

HLO_DIR = Path(__file__).resolve().parent / "data" / "hlo"
HAND = {"while": WHILE_HLO, "nested": NESTED_HLO, "collective": COLLECTIVE_HLO,
        "fusion": FUSION_HLO}
HINTS = [None, [5], [3, 5], [3]]


def _compile(name: str):
    """A dot, a scan or nested scans, compiled here, with its trip hints
    (as in tests/test_mesh_and_hlo.py)."""
    def compile_(f, *args):
        return jax.jit(f).lower(*args).compile()

    def scan(x, w):
        return jax.lax.scan(lambda c, wl: (jnp.tanh(c @ wl), ()), x, w)[0]

    def nested(x, w):
        def outer(c, wl):
            ci, _ = jax.lax.scan(lambda ci, _: (jnp.tanh(ci @ wl), ()), c, None, length=5)
            return ci, ()
        return jax.lax.scan(outer, x, w)[0]

    if name == "dot":
        return compile_(lambda a, b: a @ b, jnp.zeros((128, 256)), jnp.zeros((256, 512))), None
    if name == "scan":
        return compile_(scan, jnp.zeros((32, 64)), jnp.zeros((7, 64, 64))), [7]
    return compile_(nested, jnp.zeros((16, 32)), jnp.zeros((3, 32, 32))), [3, 5]


def _fixture(stem: str) -> tuple[str, dict]:
    with gzip.open(HLO_DIR / f"{stem}.hlo.txt.gz") as f:
        text = f.read().decode()
    return text, json.loads((HLO_DIR / f"{stem}.json").read_text())


def _both(fn_j, fn_t):
    """Both results, with the warnings each raised (as messages)."""
    out = []
    for fn in (fn_j, fn_t):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = fn()
        out.append((res, [str(w.message) for w in caught]))
    return out


def _assert_same_analysis(text: str, hints):
    cj = JA.parse_computations(text)
    ct = TA.parse_computations(text)
    assert list(cj) == list(ct)
    for name in cj:
        assert dataclasses.asdict(ct[name]) == dataclasses.asdict(cj[name]), name
    (aj, wj), (at, wt) = _both(lambda: JA.analyze_hlo(text, hints),
                               lambda: TA.analyze_hlo(text, hints))
    assert dataclasses.asdict(at) == dataclasses.asdict(aj)
    assert at.total_collective_bytes == aj.total_collective_bytes
    assert wt == wj
    entry = next(c.name for c in cj.values() if c.is_entry)
    fb = JA.fusion_body_set(cj)
    assert TA.fusion_body_set(ct) == fb
    assert TA.call_multipliers(ct, entry, fb, hints) == JA.call_multipliers(cj, entry, fb, hints)


def _assert_same_graph(text_or_compiled, hints, **kw):
    (gj, wj), (gt, wt) = _both(lambda: JCG.extract_comm_graph(text_or_compiled, hints, **kw),
                               lambda: TCG.extract_comm_graph(text_or_compiled, hints, **kw))
    assert gt.fingerprint() == gj.fingerprint()
    assert gt.n == gj.n
    for f in ("u", "v", "w", "vwgt"):
        a, b = getattr(gt, f), getattr(gj, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert gt.meta == gj.meta
    assert wt == wj
    return gt


@pytest.mark.parametrize("hints", HINTS, ids=lambda h: f"hints{h}")
@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_written_fixtures_match(name, hints):
    text = HAND[name]
    _assert_same_analysis(text, hints)
    for gran in ("fused", "op"):
        _assert_same_graph(text, hints, granularity=gran)
    for min_tasks in (2, 3):
        _assert_same_graph(text, hints, min_tasks=min_tasks, meta={"arch": "fixture"})


def test_bad_inputs_raise_and_default_placement():
    with pytest.raises(ValueError, match="granularity"):
        TCG.extract_comm_graph(FUSION_HLO, granularity="bogus")
    with pytest.raises(ValueError, match="ENTRY"):
        TCG.extract_comm_graph("HloModule empty\n")
    with pytest.raises(ValueError, match="ENTRY"):
        TA.analyze_hlo("HloModule empty\n")
    for n, k in ((10, 4), (691, 256), (3, 8)):
        got, want = TCG.default_placement(n, k), JCG.default_placement(n, k)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind,type_str,line,want", [
    ("add", "f32[8]{0}", "  %add.2 = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)", ["a", "b"]),
    ("after-all", "token[]", "  %tok = token[] after-all()", []),
    ("tuple", "(f32[4,4], s32[])",
     "  ROOT %t = (f32[4,4], s32[]) tuple(f32[4,4]{1,0} %mm, s32[] %ni)", ["mm", "ni"]),
    ("dot", "f32[128,512]", "  %d = f32[128,512] dot(%lhs, %rhs), "
     "lhs_contracting_dims={1}, rhs_contracting_dims={0}", ["lhs", "rhs"]),
])
def test_operands_variants(kind, type_str, line, want):
    got = TA._operands(TA.Op("x", type_str, kind, line))
    assert got == JA._operands(JA.Op("x", type_str, kind, line)) == want
    shapes = {"lhs": "f32[128,256]", "rhs": "f32[256,512]", "a": "f32[8]"}
    assert (TA._dot_flops(TA.Op("x", type_str, kind, line), shapes)
            == JA._dot_flops(JA.Op("x", type_str, kind, line), shapes))


def test_shape_helpers_and_tables_are_the_references():
    for t in ("(f32[4,4], s32[])", "bf16[2,3,4]{2,1,0}", "token[]", "f8e4m3fn[16]", "pred[]"):
        assert TA._shape_bytes(t) == JA._shape_bytes(t)
        assert TA._shape_numel(t) == JA._shape_numel(t)
    for name in ("_SHAPE_RE", "_OP_RE", "_CALLED_RE", "_COMP_HDR_RE"):
        assert getattr(TA, name).pattern == getattr(JA, name).pattern, name
    assert TA._DTYPE_BYTES == JA._DTYPE_BYTES and TA._MEM_SKIP == JA._MEM_SKIP
    assert TA._COLLECTIVES == JA._COLLECTIVES
    for name in ("_TRANSPARENT", "_SOURCES", "_CALLERS"):
        assert getattr(TCG, name) == getattr(JCG, name), name
    assert TCG._GROUPS_RE.pattern == JCG._GROUPS_RE.pattern


@pytest.mark.parametrize("name", ["dot", "scan", "nested_scans"])
def test_compiled_programs_match(name):
    compiled, hints = _compile(name)
    _assert_same_analysis(compiled.as_text(), hints)
    _assert_same_graph(compiled.as_text(), hints)
    _assert_same_graph(compiled, hints, granularity="op")   # duck-typed as_text()


@pytest.mark.parametrize("stem", ["whisper_tiny_train", "xlstm_125m_train"])
def test_model_fixtures_match_reference_and_sidecar(stem):
    text, side = _fixture(stem)
    hints = side["trip_hints"]
    _assert_same_analysis(text, hints)
    tg = _assert_same_graph(text, hints, min_tasks=side["min_tasks"])
    assert (tg.fingerprint().hex(), tg.n, tg.m, tg.meta["granularity"],
            tg.meta["hints_exhausted"]) == (side["fingerprint"], side["n"], side["m"],
                                            side["granularity"], side["hints_exhausted"])
