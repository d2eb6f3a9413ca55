"""The comparison that decides ``correct`` fails where it must: a run with
the timed path broken underneath, and the control, come out not correct.

The harness's look for a card is skipped (``runner.run_cell`` on the CPU);
the rest of a run is driven at a tiny size: H = 2:2, rgg 2^8 maps (direct)
and rgg 2^7 jobs placed four at a time (service), with the program's plain CPU
routes in place of its kernels.
"""
import json
import sys
import time
import types

import pytest
import torch

from mapbench import calibrate
from mapbench.harness import manifest, runner
from repro_torch.core import api, multisection
from repro_torch.serve import mapper

_FORBIDDEN = runner.forbidden_modules


def tiny_cell(kind):
    cfg = json.loads((manifest.BENCH_DIR / "configs" / f"{kind}-h486.json").read_text())
    cfg["hierarchy"] = {"a": [2, 2], "d": [1, 10]}
    if kind == "direct":
        mix = {"kind": "direct", "graph": {"family": "rgg", "log2_n": 8, "seed": 0},
               "cost_maps": 1, "cycle": 2}
    else:
        mix = {"kind": "service", "rate": 8, "burst": 4, "warmup": 4, "cost_requests": 4,
               "pool": {"size": 8, "family": "rgg", "log2_n": [7]}}
    e2e = [m for m in manifest.load_manifest()["end_to_end"]
           if "workloads" not in m or any(w.startswith(kind) for w in m["workloads"])]
    return manifest.Cell(f"tiny.{kind}", cfg, mix, 1, e2e, [])


@pytest.fixture(autouse=True)
def _shared_test_process(monkeypatch):
    """The test process also holds the JAX package's tests (xdist runs many
    files in one worker), so the run's check for loaded JAX modules, which
    guards the benchmark's own process, is left out here; test_runner_finds_jax
    holds that check itself."""
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])


def test_runner_finds_jax(monkeypatch):
    monkeypatch.setattr(runner, "forbidden_modules", _FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    found = runner.forbidden_modules()
    assert {"repro", "jax"} <= set(found) and "repro_torch" not in found
    line, rc = runner.run_cell(tiny_cell("direct"), 1, 0.0, False, "cpu",
                               time.perf_counter(), log=lambda s: None)
    assert rc == 3 and line == {}


def run(kind, seconds=0.6):
    line, rc = runner.run_cell(tiny_cell(kind), 2**31 + 99, seconds, False, "cpu",
                               time.perf_counter(), log=lambda s: None)
    assert rc == 0
    return line


def unchanged(orig):
    """A partition step that returns its state unchanged: every vertex
    stays in block 0."""
    def step(gs, *args, **kw):
        return torch.zeros(gs.vwgt.shape, dtype=torch.int32, device=gs.vwgt.device)
    return step


def half_left_out(orig):
    """Half of a dispatch's lanes left out (rounded up, so a dispatch of one
    lane loses it): the first B // 2 are partitioned, the rest keep their
    state (block 0)."""
    def step(gs, k, eps, salts, *args, **kw):
        keep = gs.vwgt.shape[0] // 2
        out = torch.zeros(gs.vwgt.shape, dtype=torch.int32, device=gs.vwgt.device)
        if keep:
            part = type(gs)(*(a[:keep] for a in gs))
            out[:keep] = orig(part, k, eps[:keep], salts[:keep], *args, **kw)
        return out
    return step


def altered(orig):
    """An answer altered where it is produced: once J is taken, one vertex
    with an edge moves to the PE farthest from it."""
    def evaluate(g, h, pe_of, device=None):
        J = orig(g, h, pe_of, device=device)
        v = int(g.rows[0])
        pe_of[v] = (pe_of[v] + h.k // 2) % h.k
        return J
    return evaluate


# fault -> (what is patched, the number that must fail)
FAULTS = {
    "state_unchanged": ([(multisection, "batched_partition", unchanged)], "imbalance"),
    "half_the_batch_left_out": ([(multisection, "batched_partition", half_left_out)],
                                "imbalance"),
    "answer_altered": ([(api, "evaluate_J", altered), (mapper, "evaluate_J", altered)],
                       "J_gap"),
}


@pytest.mark.parametrize("kind", ["direct", "service"])
def test_sound_run_is_correct(kind):
    line = run(kind)
    assert line["correct"], line
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert {"setup_s", "cost_J"} <= set(line["metrics"])
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("kind", ["direct", "service"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(kind, fault, monkeypatch):
    patches, number = FAULTS[fault]
    for module, name, make in patches:
        monkeypatch.setattr(module, name, make(getattr(module, name)))
    line = run(kind)
    assert not line["correct"], line
    assert line["checks"][number]["value"] > line["checks"][number]["limit"], line


def test_control_fails_the_comparison():
    """The control (``calibrate.readings``): the reference in the program's
    place, its J in bfloat16, reads far above the limit on the answers the
    program's own J passes."""
    cell = tiny_cell("direct")
    cell.config["hierarchy"] = {"a": [2, 2, 2], "d": [1, 10, 100]}
    cell.traffic["graph"]["log2_n"] = 9
    out = calibrate.readings(cell, [5, 2**33 + 1], 0.0, "cpu", log=lambda s: None)
    limit = cell.config["limits"]["J_gap"]
    assert out["lower"]["J_gap"] <= limit and out["lower"]["bad_pe"] == 0
    assert out["upper"]["J_gap"] > 10 * limit
    assert all(r["answers"] == 1 and r["failed"] == 0 for r in out["rows"])
