"""BENCHMARK.json against the contract's shape, the metric arithmetic, and
what importing the benchmark loads."""
import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest

from mapbench.harness import manifest, records, trace

MAN = manifest.load_manifest()
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def test_names_units_and_files():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["name"] for w in MAN["workloads"]] + [c["name"] for c in MAN["configs"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME_RE.match(n) for n in names), names
    assert all(UNIT_RE.match(m["unit"]) for m in MAN["end_to_end"] + MAN["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in MAN["end_to_end"] + MAN["per_layer"])
    assert "setup_s" in E2E and all(0.01 <= m["bound"] <= 0.25 for m in E2E.values())
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for c in MAN["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg) and cfg["limits"]["imbalance"] == cfg["eps"]
    assert len(json.dumps(MAN)) < 64 * 1024
    for text in [w["why"] for w in MAN["workloads"]] + [c["why"] for c in MAN["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    c = manifest.resolve(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer and c.chips == 1
    assert all(m["moves"] in e2e for m in c.per_layer)
    assert (manifest.BENCH_DIR / "kinds" / f"{c.traffic['kind']}.py").is_file()
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(re.match(r"^[a-z ]+$", layer) for layer in layers)


def test_percentile_is_over_all_jobs():
    lat = [0.1] * 90 + [1.0] * 5 + [5.0] * 5
    assert records.percentile(lat, 95) == 1.0
    assert records.percentile(lat + [7.0], 95) == 5.0
    assert records.percentile(list(range(1, 201)), 95) == 190
    rec = {"kind": "service", "latencies": lat + [math.inf] * 6, "trace": {"units": 106}}
    assert records.job_p95_traced_s(rec) is None   # failed jobs miss every limit


def test_rates_take_all_work_over_all_time():
    d = {"kind": "direct", "window_s": 41.0, "completed": 10}
    s = {"kind": "service", "window_s": 40.0, "completed": 250, "latencies": [1.0] * 20,
         "trace": {"units": 20}}
    assert records.map_s(d) == 4.1 and records.job_p95_traced_s(d) is None
    assert records.map_s(s) is None and records.job_p95_traced_s(s) == 1.0
    rec = {"kind": "service", "counters": {"coalesce": {"dispatches": 10, "members": 320,
                                                       "padded_lanes": 80, "groups": 30}}}
    assert records.lanes_per_dispatch(rec) == 32.0
    assert records.padded_lane_share(rec) == 20.0


def test_traced_readings():
    rec = {"kind": "direct", "levels": [[1.0, 2.0, 3.0], [3.0, 1.0, 1.0]],
           "trace": {"busy_s": 30.0, "traced_s": 40.0, "device_ops": 1000, "units": 10,
                     "kernels": {g: {"ms": 5.0, "count": 1} for g in trace.KERNEL_GROUPS}},
           "roofline": {k: {"bound_ms": 1.0, "device_ms": 4.0} for k in trace.MAPPING_KERNELS}}
    assert records.root_level_s(rec) == 2.0 and records.lower_levels_s(rec) == 3.5
    assert records.idle_pct(rec, "direct") == 25.0 and records.idle_pct(rec, "service") is None
    assert records.device_ops(rec, "direct") == 100 and records.scan_ms(rec) == 0.5
    assert records.coarsen_ms(rec) == 1.0 and records.roofline_pct(rec, "direct") == 25.0
    svc = {"kind": "service", "latencies": [1.0] * 19 + [2.0] + [9.0] * 20,
           "trace": {"units": 20}}
    assert records.job_p95_traced_s(svc) == 1.0 and records.job_p95_traced_s(rec) is None
    assert records.job_p95_traced_s({"kind": "service", "latencies": [1.0]}) is None
    untraced = {"kind": "direct"}
    assert records.roofline_pct(untraced, "direct") is None
    assert records.idle_pct(untraced, "direct") is None


def test_trace_intervals_and_gaps():
    s = np.array([0, 5, 8, 20], np.int64)
    e = np.array([10, 7, 12, 25], np.int64)
    ms, me = trace._merged(s, e)
    assert ms.tolist() == [0, 20] and me.tolist() == [12, 25]
    host = [(0, 30, "outer"), (13, 19, "inner"), (26, 28, "late")]
    starts = np.array([h[0] for h in host])
    assert trace._innermost(host, starts, 16) == "inner"
    assert trace._innermost(host, starts, 12) == "outer"
    assert trace._innermost(host[1:], starts[1:], 40) == "(no op on the host)"
    g = trace.group_ms(["void lp_gain_kernel<4>", "scan_innermost", "x"], s[:3], e[:3])
    assert g["lp_gain"] == {"ms": 10e-6, "count": 1} and g["scan"]["count"] == 1


_IMPORTS = ("import sys; sys.path.insert(0, 'src');"
            "import repro_torch.core.api, repro_torch.serve.mapper, repro_torch.kernels.ops;"
            "import mapbench.harness.runner, mapbench.harness.check, mapbench.reference.mapping;"
            "from mapbench.harness import manifest;"
            "[manifest.reader(m['name']) for m in manifest.load_manifest()['per_layer']];")


@pytest.mark.parametrize("code, banned", [
    (_IMPORTS + "import mapbench.run", ("jax", "jaxlib", "flax", "repro")),
    ("import mapbench.reference.mapping", ("jax", "jaxlib", "flax", "repro", "repro_torch")),
])
def test_imports_load_no_jax_nor_the_jax_package(code, banned):
    probe = code + ";import sys;print(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=manifest.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & set(banned)
