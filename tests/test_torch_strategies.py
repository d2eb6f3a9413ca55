"""The port's multisection strategies against the JAX package's, on the CPU.

``layer``, ``device``, ``naive``, ``queue`` and ``bucket`` with
``resident=False`` each run on the same graph in both packages with the
``ell`` refinement pinned, and return the same ``pe_of`` bit for bit. The
port's own contracts: ``device`` equals its host twin and fetches one array
per request, ``queue`` equals ``naive`` whatever the thread schedule, and
groups with different ELL caps never share a dispatch.
"""
import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.hierarchy import Hierarchy as JH
from repro.core.multisection import hierarchical_multisection as jax_multisection
from repro_torch.core import graph as TG
from repro_torch.core import multisection as TM
from repro_torch.core.api import SharedMapConfig, shared_map_direct
from repro_torch.core.hierarchy import Hierarchy

# (name, strategy, resident); instance and hierarchy per case below
CASES = [("layer", "layer", None), ("device", "device", None),
         ("naive", "naive", None), ("queue", "queue", None),
         ("bucket-host", "bucket", False)]
INSTANCES = {"rgg2000-4:2": (lambda: JG.gen_rgg(2000, seed=3), (4, 2), "fast"),
             "grid32-2:2:2": (lambda: JG.gen_grid(32), (2, 2, 2), "fast")}
D = (1.0, 10.0, 100.0)


def to_torch(jg) -> TG.Graph:
    return TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in TG.Graph._fields},
                               device="cpu")


def _run_port(tg, a, preset, strategy, resident, **kw):
    TM.reset_transfer_stats()
    res = TM.hierarchical_multisection(tg, Hierarchy(a, D[: len(a)]), preset=preset,
                                       strategy=strategy, resident=resident, seed=1,
                                       backend="ell", device="cpu", **kw)
    return res, TM.transfer_stats()


@pytest.fixture(scope="module")
def runs():
    """JAX and port results of every case: rgg 2000 on 4:2 for all five;
    grid 32x32 on 2:2:2 (an eps exponent of 1/3 at the root) for device."""
    out = {}
    for inst, (make, a, preset) in INSTANCES.items():
        jg = make()
        tg = to_torch(jg)
        out[inst, "graph"] = tg
        for name, strategy, resident in CASES:
            if inst.startswith("grid") and strategy != "device":
                continue
            jr = jax_multisection(jg, JH(a, D[: len(a)]), preset=preset,
                                  strategy=strategy, resident=resident, seed=1,
                                  backend="ell")
            out[inst, name] = (jr, *_run_port(tg, a, preset, strategy, resident))
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_strategy_matches_reference_bitwise(runs, name):
    jr, tr, _ = runs["rgg2000-4:2", name]
    assert tr.pe_of.dtype == np.int32
    assert np.array_equal(tr.pe_of, jr.pe_of)
    for key in ("partition_calls", "padded_vertex_work", "real_vertex_work"):
        assert tr.stats[key] == jr.stats[key], key
    assert tr.stats["backend"] == "ell"
    assert len(tr.stats["levels"]) == len(jr.stats["levels"])


def test_device_with_three_levels_matches_reference(runs):
    jr, tr, _ = runs["grid32-2:2:2", "device"]
    assert np.array_equal(tr.pe_of, jr.pe_of)
    assert tr.stats["partition_calls"] == jr.stats["partition_calls"] == 7


@pytest.mark.parametrize("inst", sorted(INSTANCES))
def test_device_equals_host_twin_with_one_fetch(runs, inst):
    _, tr, xfer = runs[inst, "device"]
    _, a, preset = INSTANCES[inst]
    twin, twin_xfer = _run_port(runs[inst, "graph"], a, preset, "device", False)
    assert np.array_equal(tr.pe_of, twin.pe_of)
    assert tr.stats["partition_calls"] == twin.stats["partition_calls"]
    assert tr.stats["resident"] and not twin.stats["resident"]
    assert xfer["d2h_array_fetches"] == 1          # the final pe_of only
    assert xfer["d2h_meta_fetches"] == 1           # the root's n and m
    assert twin_xfer["d2h_array_fetches"] > 1      # the host mirror fetches per level


def test_queue_equals_naive_and_bucket(runs):
    _, naive, _ = runs["rgg2000-4:2", "naive"]
    _, queue, _ = runs["rgg2000-4:2", "queue"]
    assert np.array_equal(queue.pe_of, naive.pe_of)
    bucket, _ = _run_port(runs["rgg2000-4:2", "graph"], (4, 2), "fast", "bucket", None)
    assert np.array_equal(bucket.pe_of, naive.pe_of)
    # one worker, the other schedule extreme: the same result
    ctx_runs = TM._run_queue
    try:
        TM._run_queue = lambda work, ctx: ctx_runs(work, ctx, workers=1)
        solo, _ = _run_port(runs["rgg2000-4:2", "graph"], (4, 2), "fast", "queue", None)
    finally:
        TM._run_queue = ctx_runs
    assert np.array_equal(solo.pe_of, naive.pe_of)


def test_queue_checkpoint_aborts():
    g = TG.gen_grid(12, device="cpu")
    calls = []

    def checkpoint():
        calls.append(1)
        if len(calls) > 2:
            raise TimeoutError("deadline")
    with pytest.raises(TimeoutError):
        shared_map_direct(g, Hierarchy((2, 2), (1.0, 10.0)),
                          SharedMapConfig(strategy="queue", preset="fast"),
                          checkpoint=checkpoint, device="cpu")


def test_resident_applies_only_to_planner_strategies():
    g = TG.gen_grid(8, device="cpu")
    with pytest.raises(ValueError, match="resident"):
        TM.hierarchical_multisection(g, Hierarchy((2, 2), (1.0, 10.0)),
                                     strategy="naive", resident=True, device="cpu")


def test_exec_key_separates_ell_caps():
    """Two groups that differ only in their ELL cap never merge."""
    base = dict(members=[], N=64, M=256, arity=2, levels=1, preset="eco",
                backend="ell", eps=[], salts=[])
    a = TM.PlanGroup(deg=8, **base)
    b = TM.PlanGroup(deg=16, **base)
    assert a.exec_key != b.exec_key
    with pytest.raises(ValueError, match="exec keys"):
        TM.dispatch_group_batch([a, b], "cpu")
