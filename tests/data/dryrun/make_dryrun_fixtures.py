"""Write the dry-run fixtures of the port's dry-run tests (needs JAX), and
the sweep table that holds the port's whole sweep against the reference's.

    PYTHONPATH=src python tests/data/dryrun/make_dryrun_fixtures.py [arch ...]
    PYTHONPATH=src python tests/data/dryrun/make_dryrun_fixtures.py --sweep \\
        --mesh both --out results/dryrun_ref.jsonl [--jobs 3] [--timeout 1800]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --device cpu --out results/dryrun_torch.jsonl
    python tests/data/dryrun/make_dryrun_fixtures.py --table \\
        results/dryrun_ref.jsonl results/dryrun_torch.jsonl

The first form runs, for each held cell (``CELLS``), the JAX package's own
dry-run CLI in a subprocess (``python -m repro.launch.dryrun --arch A
--shape S --mesh M --out F``: 256 or 512 forced host devices, the
production mesh, lower and compile of the sharded step) and writes its one
record, beside this script, as ``<arch>__<shape>__<mesh>.json`` (only the
cells of the archs named, if any are). Two keys are dropped: ``trace``
(present only in a failed record) and ``roofline``, whose seconds are
reckoned from another chip's peak rates and are not compared with anything.

``--sweep`` runs the same CLI over every cell of ``all_cells()`` on the
meshes named, one subprocess and one timeout per cell, ``--jobs`` at once,
and appends each record (or its error, or the timeout) to ``--out`` as a
JSON line; a rerun skips the cells recorded there. ``--table`` reads such a
file and the port's sweep (``repro_torch.launch.dryrun --all``) and writes
``sweep.json`` beside this script: for each cell both sides' argument and
alias bytes, the port's FLOPs and collective bytes over the reference's, or
either side's error.

The port's ``repro_torch.launch.dryrun.run_cell`` is held against these
records by ``tests/test_torch_dryrun.py``: the mode and chip count equal,
``memory.argument_bytes`` and ``alias_bytes`` equal to the byte, and the
per-device FLOPs within 2% of their ratio in ``flops_ratio.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
CELLS = (("whisper-tiny", "train_4k", "pod1"),
         ("moonshot-v1-16b-a3b", "decode_32k", "pod1"),
         ("llama3.2-3b", "decode_32k", "pod1"),
         ("llama3.2-3b", "train_4k", "pod1"),
         ("qwen2-72b", "prefill_32k", "pod1"),
         ("jamba-v0.1-52b", "prefill_32k", "pod1"),
         ("jamba-v0.1-52b", "train_4k", "pod1"),
         ("jamba-v0.1-52b", "decode_32k", "pod1"),
         ("xlstm-125m", "train_4k", "pod1"),
         ("whisper-tiny", "train_4k", "pod2"))
DROP = ("trace", "roofline")
TABLE = HERE / "sweep.json"


def fixture_path(arch: str, shape: str, mesh: str) -> Path:
    return HERE / f"{arch.replace('.', '_')}__{shape}__{mesh}.json"


def reference_record(arch: str, shape: str, mesh: str, timeout: float | None = None,
                     strict: bool = True) -> dict:
    """The reference CLI's record of one cell, ``trace`` and ``roofline``
    dropped. ``strict=False`` returns a failed or timed-out cell as a record
    with ``error`` instead of raising."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun.jsonl"
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", mesh, "--out", str(out)],
                env=env, cwd=REPO, timeout=timeout, capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            if strict:
                raise
            return {"arch": arch, "shape": shape, "mesh": mesh,
                    "error": f"timeout after {timeout:.0f} s"}
        lines = out.read_text().splitlines() if out.exists() else []
        if proc.returncode != 0 or not lines:
            if strict:
                raise RuntimeError(f"{arch} x {shape} x {mesh}: rc {proc.returncode}\n"
                                   f"{proc.stderr[-3000:]}")
            return {"arch": arch, "shape": shape, "mesh": mesh,
                    "error": f"rc {proc.returncode}: {proc.stderr.strip()[-300:]}"}
        rec = json.loads(lines[-1])
    if "error" in rec and strict:
        raise RuntimeError(f"{arch} x {shape} x {mesh}: {rec['error']}")
    return {k: v for k, v in rec.items() if k not in DROP}


def write_fixtures(archs: list[str]) -> None:
    import jax
    for arch, shape, mesh in CELLS:
        if archs and arch not in archs:
            continue
        rec = reference_record(arch, shape, mesh)
        rec["jax_version"] = jax.__version__
        path = fixture_path(arch, shape, mesh)
        path.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
        print(f"wrote {path.relative_to(REPO)}: argument_bytes "
              f"{rec['memory']['argument_bytes']}", flush=True)


def _read_jsonl(path) -> dict:
    """{(arch, shape, mesh): record}, the last line of a cell winning."""
    recs = {}
    if os.path.exists(path):
        for line in Path(path).read_text().splitlines():
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def sweep(meshes: list[str], out: str, jobs: int, timeout: float) -> None:
    """Every cell of ``all_cells()`` on ``meshes`` through the reference's
    CLI, ``jobs`` subprocesses at once, each record appended to ``out``."""
    import threading

    import jax
    from repro.configs.registry import all_cells
    done = {k for k, r in _read_jsonl(out).items() if "error" not in r}
    todo, lock = [], threading.Lock()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "a") as f:
        for arch, _, cell, ok, why in all_cells():
            for mesh in meshes:
                if (arch, cell.name, mesh) in done:
                    continue
                if not ok:
                    f.write(json.dumps({"arch": arch, "shape": cell.name, "mesh": mesh,
                                        "skipped": why}) + "\n")
                else:
                    todo.append((arch, cell.name, mesh))

        def one(key):
            rec = reference_record(*key, timeout=timeout, strict=False)
            rec["jax_version"] = jax.__version__
            with lock:
                f.write(json.dumps(rec) + "\n")
                f.flush()
            tag = " x ".join(key)
            print(f"[{'FAIL' if 'error' in rec else ' ok '}] {tag}"
                  + (f": {rec['error'][:200]}" if "error" in rec else
                     f": compile {rec.get('compile_s')} s"), flush=True)

        with ThreadPoolExecutor(jobs) as pool:
            list(pool.map(one, todo))


def _side(rec: dict | None) -> dict:
    if rec is None:
        return {"error": "not recorded"}
    if "skipped" in rec:
        return {"skipped": rec["skipped"]}
    if "error" in rec:
        return {"error": rec["error"][:300]}
    return {"argument_bytes": rec["memory"]["argument_bytes"],
            "alias_bytes": rec["memory"]["alias_bytes"],
            "flops_per_device": rec["hlo"]["flops_per_device"],
            "collective_total": rec["hlo"]["collective_total"],
            "while_trips": rec["hlo"].get("while_trips", [])}


def table(ref_path: str, port_path: str) -> dict:
    """The sweep table (``TABLE``) of the two sweeps' records."""
    ref, port = _read_jsonl(ref_path), _read_jsonl(port_path)
    cells = {}
    for key in sorted(set(ref) | set(port)):
        r, p = _side(ref.get(key)), _side(port.get(key))
        row = {"reference": r, "port": p}
        if "flops_per_device" in r and "flops_per_device" in p:
            row["flops_ratio"] = p["flops_per_device"] / r["flops_per_device"]
            row["collective_ratio"] = (p["collective_total"] / r["collective_total"]
                                       if r["collective_total"] else None)
            row["argument_bytes_equal"] = p["argument_bytes"] == r["argument_bytes"]
            row["alias_bytes_equal"] = p["alias_bytes"] == r["alias_bytes"]
        cells[" x ".join(key)] = row
    return {"about": "The reference's dry-run sweep (repro.launch.dryrun, its CLI in a "
                     "subprocess per cell) beside the port's (repro_torch.launch.dryrun "
                     "--all --mesh both, CPU), cell by cell: both sides' argument and "
                     "alias bytes, the port's per-device FLOPs and collective bytes over "
                     "the reference's, or either side's error. Written by "
                     "make_dryrun_fixtures.py --table.",
            "cells": cells}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun_ref.jsonl")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--table", nargs=2, metavar=("REF_JSONL", "PORT_JSONL"))
    args = ap.parse_args(argv)
    if args.table:
        TABLE.write_text(json.dumps(table(*args.table), indent=1, sort_keys=True) + "\n")
        print(f"wrote {TABLE.relative_to(REPO)}")
    elif args.sweep:
        sweep(["pod1", "pod2"] if args.mesh == "both" else [args.mesh],
              args.out, args.jobs, args.timeout)
    else:
        write_fixtures(args.archs)


if __name__ == "__main__":
    main()
