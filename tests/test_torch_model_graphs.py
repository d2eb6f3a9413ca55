"""Graph extraction from the port's own models (``repro_torch.launch``:
``fx_analysis``, ``comm_graph.compile_model_cell``/``model_comm_graph``/
``extract_fx_graph``) against the JAX package, on the CPU.

The reference compiles a model's train cell to HLO and extracts its task
graph (``tests/test_model_graphs.py``); the port exports its own loss with
``torch.export`` and extracts from that graph. The two IRs differ, so the
graphs are not compared bit for bit; their FLOP totals are (whisper-tiny's
export against the committed HLO fixture of the same cell, and small
programs compiled by JAX beside their torch counterparts). Each graph
passes the reference's extraction contract: n >= 2k after the
``min_tasks`` escalation, positive edge weights, real FLOP weights, a
deterministic fingerprint. Mapped on the chip hierarchy, the xLSTM graph
beats the default placement's J. whisper-tiny's does not: its unembed task
holds 54% of the cell's FLOPs, more than one top-level block of 16 PEs may
hold, so the balance constraint places its neighbours (the weight cast
and the logits, 66 MB of edges) apart from it, while program order keeps
them on one PE; the reference's mapper gives the same ``pe_of`` on that
graph, which the test holds. The xLSTM graph is the smoke config's at seq
16, for this suite's time (the full xlstm-125m export takes ~26 s here)."""
import gzip
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map_direct as jax_shared_map
from repro.core.taskgraph import TaskGraph as JTaskGraph
from repro.launch import hlo_analysis as JA
from repro.launch import mesh as JM
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.api import SharedMapConfig, shared_map_direct
from repro_torch.core.mapping import evaluate_J
from repro_torch.launch import comm_graph as CG
from repro_torch.launch import fx_analysis as FX
from repro_torch.launch.mesh import physical_hierarchy

HLO_DIR = Path(__file__).resolve().parent / "data" / "hlo"
H = physical_hierarchy(False)
FLOP_RTOL = 0.005


def _xlstm_cell():
    return CG.export_train_cell(get_smoke_config("xlstm-125m"), seq_len=16, batch=4)


@pytest.fixture(scope="module")
def cells():
    """Each cell's export, and its graph from a second export (the
    fingerprint must not move): whisper-tiny's through ``model_comm_graph``."""
    return {"whisper-tiny": (CG.compile_model_cell("whisper-tiny")[0],
                             CG.model_comm_graph("whisper-tiny", min_tasks=2 * H.k)),
            "xlstm-smoke": (_xlstm_cell(),
                            CG.extract_fx_graph(_xlstm_cell(), min_tasks=2 * H.k))}


@pytest.mark.parametrize("name", ["whisper-tiny", "xlstm-smoke"])
def test_extracted_graph_is_mappable(cells, name):
    first, again = cells[name]
    tg = CG.extract_fx_graph(first, min_tasks=2 * H.k, meta={"arch": name})
    assert tg.n >= 2 * H.k   # min_tasks escalated to op granularity
    assert tg.meta["granularity"] == "op"
    assert tg.meta["source"] == "export" and tg.meta["arch"] == name
    assert tg.m > 0 and float(tg.w.min()) > 0
    assert float(tg.vwgt.max()) > 1.0   # the products carry real FLOP weights
    assert again.fingerprint() == tg.fingerprint()
    fused = CG.extract_fx_graph(first, granularity="fused")
    op = CG.extract_fx_graph(first, granularity="op")
    assert fused.meta["granularity"] == "fused" and fused.n < op.n
    assert op.fingerprint() == tg.fingerprint()
    # fusion moves FLOPs between tasks, never loses them
    assert float(fused.vwgt.astype(np.float64).sum()) == pytest.approx(
        float(op.vwgt.astype(np.float64).sum()) - (op.n - fused.n), rel=1e-6)
    # the closed loop: mapped on the chip hierarchy
    g = tg.to_graph(device="cpu")
    res = shared_map_direct(tg, H, SharedMapConfig(preset="fast", backend="xla"),
                            device="cpu")
    j_default = evaluate_J(g, H, CG.default_placement(tg.n, H.k), device="cpu")
    assert res.pe_of.shape == (int(g.N),)
    assert 0 <= int(res.pe_of.min()) and int(res.pe_of[:tg.n].max()) < H.k
    if name == "xlstm-smoke":
        assert res.J < j_default, (res.J, j_default)
    else:   # see the module docstring: the reference's mapping, J above program order's
        jtg = JTaskGraph.from_edges(tg.n, tg.u, tg.v, tg.w, vwgt=tg.vwgt)
        assert jtg.fingerprint() == tg.fingerprint()
        want = jax_shared_map(jtg, JM.physical_hierarchy(False),
                              JConfig(preset="fast", backend="xla"))
        assert np.array_equal(res.pe_of, want.pe_of) and res.J == pytest.approx(want.J,
                                                                                rel=1e-6)


def test_model_comm_graph_whisper_flops_match_the_hlo_fixture(cells):
    """whisper-tiny's train cell at the fixture's shape: the export's FLOPs
    equal the reference's HLO graph's, within 0.5% (equal to 4 digits)."""
    tg = cells["whisper-tiny"][1]    # model_comm_graph("whisper-tiny", min_tasks=512)
    assert tg.n >= 512
    assert {k: tg.meta[k] for k in ("source", "arch", "seq_len", "batch", "mode")} == {
        "source": "export", "arch": "whisper-tiny", "seq_len": 64, "batch": 4,
        "mode": "train"}
    with gzip.open(HLO_DIR / "whisper_tiny_train.hlo.txt.gz") as f:
        text = f.read().decode()
    side = json.loads((HLO_DIR / "whisper_tiny_train.json").read_text())
    ref = CG.extract_comm_graph(text, side["trip_hints"], min_tasks=side["min_tasks"])
    want = float(ref.vwgt.astype(np.float64).sum())
    got = float(tg.vwgt.astype(np.float64).sum())
    assert got == pytest.approx(want, rel=FLOP_RTOL)
    dots = FX.total_flops(cells["whisper-tiny"][0].graph)
    assert dots == pytest.approx(JA.analyze_hlo(text, side["trip_hints"]).flops, rel=1e-4)


def _export(fn, *shapes):
    class Cell(torch.nn.Module):
        def forward(self, *xs):
            return fn(*xs)
    args = tuple(torch.empty(s, device="meta") for s in shapes)
    return torch.export.export(Cell(), args, strict=False).graph


@pytest.mark.parametrize("case", ["matmul", "einsum", "bmm", "addmm", "two_dots"])
def test_fx_flops_match_the_references_hlo_flops(case):
    """One small program in both frameworks: the export's FLOPs equal those
    that ``hlo_analysis`` reads from JAX's optimized HLO."""
    progs = {
        "matmul": ((lambda a, b: a @ b, lambda a, b: a @ b), [(4, 8, 16), (16, 32)]),
        "einsum": ((lambda a, b: torch.einsum("bqhd,bkhd->bhqk", a, b),
                    lambda a, b: jnp.einsum("bqhd,bkhd->bhqk", a, b)),
                   [(2, 16, 3, 8), (2, 12, 3, 8)]),
        "bmm": ((torch.bmm, jnp.matmul), [(3, 5, 7), (3, 7, 11)]),
        "addmm": ((lambda c, a, b: torch.addmm(c, a, b), lambda c, a, b: c + a @ b),
                  [(6, 10), (6, 9), (9, 10)]),
        "two_dots": ((lambda a, b, c: torch.tanh(a @ b) @ c,
                      lambda a, b, c: jnp.tanh(a @ b) @ c), [(8, 16), (16, 24), (24, 4)]),
    }
    (tfn, jfn), shapes = progs[case]
    got = FX.total_flops(_export(tfn, *shapes))
    hlo = jax.jit(jfn).lower(*[jnp.zeros(s) for s in shapes]).compile().as_text()
    assert got == JA.analyze_hlo(hlo).flops > 0


def test_node_kinds_and_fused_groups():
    """Views are transparent, factories are sources, a pointwise chain with
    one consumer joins it (fused) and stays apart (op)."""
    def fn(x, w):
        y = (x.reshape(4, 8) @ w).float()          # a cast: pointwise
        z = torch.tanh(y) * torch.arange(16.0, device=x.device)
        return z.sum()
    graph = _export(fn, (32,), (8, 16))
    kinds = {n.name: (FX.is_source(n), FX.is_transparent(n), FX.is_task(n))
             for n in graph.nodes if n.op == "call_function"}
    assert kinds["reshape"] == (False, True, False)
    assert kinds["arange"] == (True, False, False)
    assert kinds["matmul"] == (False, False, True)
    op = CG.extract_fx_graph(graph, granularity="op")
    fused = CG.extract_fx_graph(graph, granularity="fused")
    # op: matmul, to, tanh, mul, sum; fused: the chain ends in the sum
    assert op.n == sum(k[2] for k in kinds.values()) == 5
    assert fused.n == 2 and float(fused.vwgt.max()) == 2 * 4 * 8 * 16
    assert op.meta["source"] == "export"


def test_compile_model_cell_modes():
    with pytest.raises(ValueError, match="train"):
        CG.compile_model_cell("whisper-tiny", mode="prefill")
    with pytest.raises(ValueError, match="granularity"):
        CG.extract_fx_graph(_export(lambda a: a * 2, (3,)), granularity="block")
