"""The benchmark's manifest: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name:

* a configuration: the ``file`` of its entry in ``configs``;
* a traffic mix: ``mapbench/traffic/<traffic>.json``, data whose ``kind``
  names the code that drives it, ``mapbench/kinds/<kind>.py``
  (:mod:`mapbench.harness.traffic`), and whose graphs name their generator,
  ``mapbench/generators/<family>.py``;
* a metric (end-to-end or per-layer): ``mapbench/metrics/<name>.py``, whose
  ``read(rec)`` returns the metric's value from a run's record, or None
  where the record holds nothing to read.

A cell reports the end-to-end metrics that list it under ``workloads`` or
that have no such key, and (with ``--trace 1``) the per-layer metrics that
list it, or that have no ``workloads`` key and move an end-to-end metric the
cell reports.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load_manifest() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str, e2e_names: set[str] | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def resolve(workload: str) -> Cell:
    """The cell named ``workload`` with its configuration, traffic and metrics."""
    man = load_manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in man["end_to_end"] if _applies(m, workload, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, workload, names)]
    return Cell(name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


_LOADED: dict = {}


def plugin(folder: str, name: str):
    """The module ``mapbench/<folder>/<name>.py``, loaded once by its path (a
    name may hold dots, so it is not imported as a package member)."""
    path = BENCH_DIR / folder / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"{folder} has no {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"mapbench_{folder}_" + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(name: str):
    """The ``read(rec)`` function of ``mapbench/metrics/<name>.py``."""
    return plugin("metrics", name).read


def read_metrics(metrics: list[dict], rec: dict, required: bool) -> dict:
    """``{name: {"value", "unit"}}`` for each metric whose reader finds a
    value; with ``required`` a metric with nothing to read is an error."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(rec)
        if value is None:
            if required:
                raise RuntimeError(f"metric {m['name']} found nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
