"""Write the dry-run fixtures of the port's dry-run tests (needs JAX).

    PYTHONPATH=src python tests/data/dryrun/make_dryrun_fixtures.py [arch ...]

For each cell it runs the JAX package's own dry-run CLI in a subprocess
(``python -m repro.launch.dryrun --arch A --shape S --mesh M --out F``: 256
or 512 forced host devices, the production mesh, lower and compile of the
sharded step) and writes its one record, beside this script, as
``<arch>__<shape>__<mesh>.json`` (only the cells of the archs named, if
any are). Two keys are dropped: ``trace`` (present
only in a failed record) and ``roofline``, whose seconds are reckoned from
another chip's peak rates and are not compared with anything.

The port's ``repro_torch.launch.dryrun.run_cell`` is held against these
records by ``tests/test_torch_dryrun.py``: the mode and chip count equal,
``memory.argument_bytes`` equal to the byte, and the per-device FLOPs and
collective bytes printed beside the port's.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
CELLS = (("whisper-tiny", "train_4k", "pod1"),
         ("moonshot-v1-16b-a3b", "decode_32k", "pod1"),
         ("llama3.2-3b", "decode_32k", "pod1"),
         ("llama3.2-3b", "train_4k", "pod1"),
         ("qwen2-72b", "prefill_32k", "pod1"),
         ("jamba-v0.1-52b", "prefill_32k", "pod1"))
DROP = ("trace", "roofline")


def fixture_path(arch: str, shape: str, mesh: str) -> Path:
    return HERE / f"{arch.replace('.', '_')}__{shape}__{mesh}.json"


def reference_record(arch: str, shape: str, mesh: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun.jsonl"
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh", mesh, "--out", str(out)],
                       check=True, env=env, cwd=REPO)
        rec = json.loads(out.read_text().splitlines()[-1])
    if "error" in rec:
        raise RuntimeError(f"{arch} x {shape} x {mesh}: {rec['error']}")
    return {k: v for k, v in rec.items() if k not in DROP}


def main(archs: list[str]) -> None:
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


if __name__ == "__main__":
    main(sys.argv[1:])
