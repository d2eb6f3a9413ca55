"""Write the HLO fixtures of the port's ingestion tests (needs JAX).

    PYTHONPATH=src python tests/data/hlo/make_hlo_fixtures.py

For each arch it compiles one train cell with the JAX package
(``repro.launch.comm_graph.compile_model_cell``, seq_len 64, batch 4) and
writes, beside this script,

* ``<arch>_train.hlo.txt.gz``: the optimized HLO text (gzip, mtime 0),
  source paths made relative to the repository;
* ``<arch>_train.json``: the trip hints, the JAX version, and the JAX
  package's own results on that text: ``extract_comm_graph(text, hints,
  min_tasks=512)`` (fingerprint, n, m, granularity), then J of
  ``shared_map`` on ``physical_hierarchy()`` (16:16, D 1:10, k 256) with
  ``SharedMapConfig(preset="fast", backend="xla")`` (and a blake2b digest of
  its ``pe_of``), and J of ``default_placement``.

A GPU machine has no JAX, so it never compiles HLO: the port reads these
texts and is held against the recorded results there, and a CPU test holds
the sidecars against the live JAX package, so a stale sidecar fails.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
ARCHS = ("whisper-tiny", "xlstm-125m")
SEQ_LEN, BATCH = 64, 4
MIN_TASKS = 512          # 2 * k of physical_hierarchy()


def fixture_paths(arch: str) -> tuple[Path, Path]:
    stem = arch.replace("-", "_").replace(".", "_") + "_train"
    return HERE / f"{stem}.hlo.txt.gz", HERE / f"{stem}.json"


def reference_record(text: str, hints: list[int]) -> dict:
    """The JAX package's extraction and closed loop on one HLO text."""
    import numpy as np

    from repro.core.api import SharedMapConfig, shared_map_direct
    from repro.core.mapping import evaluate_J
    from repro.launch.comm_graph import default_placement, extract_comm_graph
    from repro.launch.mesh import physical_hierarchy

    tg = extract_comm_graph(text, hints, min_tasks=MIN_TASKS)
    h = physical_hierarchy(False)
    g = tg.to_graph()
    res = shared_map_direct(g, h, SharedMapConfig(preset="fast", backend="xla"))
    pe = np.ascontiguousarray(res.pe_of[: tg.n], np.int32)
    return {"fingerprint": tg.fingerprint().hex(), "n": tg.n, "m": tg.m,
            "granularity": tg.meta["granularity"],
            "hints_exhausted": tg.meta["hints_exhausted"],
            "J_xla_fast": res.J,
            "pe_of_blake2b": hashlib.blake2b(pe.tobytes(), digest_size=16).hexdigest(),
            "J_default": evaluate_J(g, h, default_placement(tg.n, h.k))}


def main() -> int:
    import jax

    from repro.launch.comm_graph import compile_model_cell

    for arch in ARCHS:
        compiled, hints = compile_model_cell(arch, seq_len=SEQ_LEN, batch=BATCH)
        # the text's FileNames table holds the compiling checkout's paths:
        # keep them relative to the repository, so the fixture does not
        # depend on where it was made
        text = compiled.as_text().replace(f'"{REPO}/', '"')
        hlo_path, json_path = fixture_paths(arch)
        with open(hlo_path, "wb") as f, gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as z:
            z.write(text.encode())
        rec = {"arch": arch, "seq_len": SEQ_LEN, "batch": BATCH, "mode": "train",
               "trip_hints": list(hints), "jax_version": jax.__version__,
               "hlo_bytes": len(text.encode()), "min_tasks": MIN_TASKS,
               "hierarchy": {"a": [16, 16], "d": [1.0, 10.0]},
               "config": {"preset": "fast", "backend": "xla"}}
        rec.update(reference_record(text, list(hints)))
        json_path.write_text(json.dumps(rec, indent=1) + "\n")
        print(f"{arch}: {rec['hlo_bytes']} B of HLO, {hlo_path.stat().st_size} B "
              f"gzipped, n {rec['n']} m {rec['m']} {rec['granularity']}, J "
              f"{rec['J_xla_fast']} against {rec['J_default']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
