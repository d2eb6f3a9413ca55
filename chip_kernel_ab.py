#!/usr/bin/env python3
"""Times this checkout's ``lp_gain`` and ``contract_edges`` kernels against
an earlier design of the same two kernels, in one process on one NVIDIA GPU.

    python3 chip_kernel_ab.py --old OLD_CHECKOUT [--out FILE.json]

``OLD_CHECKOUT`` is the root of an earlier checkout of this repository, for
example the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Its ``src/repro_torch/kernels/csrc/lp_gain.cu`` and
``contract_edges.cu`` are built with its own nvcc flags (read from its
``kernels/_build.py``, whose entry signatures must equal this checkout's)
and called in place of this checkout's two entry points; everything else
runs from this checkout.

1. Runs ``chip_smoke.py``'s mapping main path (``gen_rgg(2**20, seed=0)`` on
   4:8:6, ``SharedMapConfig()``, ``ell`` on the card) with every launch of
   the mapping kernels timed behind a spin on the card
   (``chip_smoke._timed_main_path``), first with the old kernels, then with
   this checkout's, and requires the same ``pe_of`` from both. Prints each
   kernel's summed ms, by padded N.
2. On the inputs this checkout's run captured at each padded N (2^20, 2^18,
   2^15), holds both designs bitwise against the plain version and times
   each twice, in turns (old, new, new, old), each timing the median of 20
   event-timed runs (50 below N = 2^19) without the spin (``ms``, as
   ``chip_smoke.py``'s ``ms``) and with it (``device_ms``).
3. Prints one JSON object as the last line and writes it to ``--out``.

It exits with code 2 without a CUDA device. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = ("lp_gain.cu", "contract_edges.cu")
ENTRIES = ("lp_gain_f32", "contract_edges_f32")


def _load_old(old_root: Path, build_dir: Path):
    """Build the earlier checkout's two sources into one library and bind
    their entry points, which must take this checkout's arguments."""
    from repro_torch.kernels import _build
    csrc = old_root / "src/repro_torch/kernels/csrc"
    spec = importlib.util.spec_from_file_location(
        "old_build", old_root / "src/repro_torch/kernels/_build.py")
    old_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_build)
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / "libold_lp_gain_contract_edges.so"
    res = subprocess.run([_build._nvcc(), *old_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                          *(str(csrc / s) for s in SOURCES), "-o", str(out)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError("nvcc failed on the old sources:\n" + res.stdout + res.stderr)
    for line in (res.stdout + res.stderr).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used")):
            print(f"ptxas old: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    for name in ENTRIES:
        if old_build._SIGNATURES[name] != _build._SIGNATURES[name]:
            raise RuntimeError(f"the old {name} takes other arguments than this checkout's")
        fn = getattr(lib, name)
        fn.argtypes = old_build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


class _Swap:
    """Stands in for ``_build._LIB``: the two entries from ``over``, the
    rest from ``base``."""

    def __init__(self, base, over):
        self.base, self.over = base, over

    def __getattr__(self, name):
        if name in ENTRIES:
            return getattr(self.over, name)
        return getattr(self.base, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, help="root of an earlier checkout")
    ap.add_argument("--out", type=Path, default=None, help="JSON summary file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import graph as G
    from repro_torch.core.api import SharedMapConfig, shared_map
    from repro_torch.core.hierarchy import parse_hierarchy
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    new = _build.library()
    designs = {"old": _load_old(args.old.resolve(), _build.BUILD_DIR / "ab_old"), "new": new}

    def use(name):
        _build._LIB = _Swap(new, designs[name])

    g = G.gen_rgg(cs.RGG_N, seed=0, device=dev)
    h = parse_hierarchy(*cs.HIERARCHY)
    small = G.gen_rgg(2000, seed=3, device=dev)
    for name in designs:   # every module loaded and both designs run once
        use(name)
        shared_map(small, h, SharedMapConfig(), device=dev)
    result = {"card": smi, "main_path": {}, "shapes": {}}
    pes, caps = {}, None
    for name in designs:
        use(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, times, caps = cs._timed_main_path(
            lambda: shared_map(g, h, SharedMapConfig(), device=dev), kops)
        sec = time.perf_counter() - t0
        pes[name] = res.pe_of
        summ = {k: {"ms": sum(map(sum, per.values())),
                    "by_n": {str(n): {"launches": len(v), "ms": sum(v)}
                             for n, v in sorted(per.items(), reverse=True)}}
                for k, per in times.items()}
        result["main_path"][name] = {"seconds": sec, "J": res.J, "kernels": summ}
        print(f"main path [{name}]: {sec:.2f} s (events' host cost included), J {res.J}; "
              + "; ".join(f"{k} {v['ms']:.4f} ms (" + ", ".join(
                  f"n={n}: {d['launches']} launches {d['ms']:.4f} ms"
                  for n, d in v["by_n"].items()) + ")" for k, v in summ.items()), flush=True)
    if not np.array_equal(pes["old"], pes["new"]):
        raise AssertionError("the two designs gave different pe_of on the main path")
    print("main path: the same pe_of under both designs", flush=True)

    order = list(designs) + list(designs)[::-1]
    for kern, case in (("contract_edges", cs._contract_case), ("lp_gain", cs._lp_gain_case)):
        for n in sorted(caps[kern], reverse=True):
            label, kernel, plain, kargs, nbytes, flops, _ = case(caps[kern][n])
            bound_ms, bound_by = cs._bound(nbytes, flops)
            want = plain(*kargs)
            for name in designs:
                use(name)
                got = kernel(*kargs)
                if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                           for a, b in zip(got, want)):
                    raise AssertionError(f"{kern} [{name}] at {label}: not bitwise")
            reps = 50 if n < 2**19 else 20
            rec = {"label": label, "bound_ms": bound_ms, "bound_by": bound_by,
                   "ms": {k: [] for k in designs}, "device_ms": {k: [] for k in designs}}
            for name in order:
                use(name)
                rec["ms"][name].append(cs._time_ms(lambda: kernel(*kargs), reps, 3))
                rec["device_ms"][name].append(
                    cs._time_ms(lambda: kernel(*kargs), reps, 3, pad=True))
            result["shapes"][f"{kern}@{n}"] = rec
            print(f"{kern} at {label}, bitwise under both designs; bound {bound_ms:.5f} ms "
                  f"({bound_by}); ms, device_ms (two timings each): " + "; ".join(
                      f"{k} {rec['ms'][k][0]:.5f}/{rec['ms'][k][1]:.5f}, "
                      f"{rec['device_ms'][k][0]:.5f}/{rec['device_ms'][k][1]:.5f}"
                      for k in designs), flush=True)
    use("new")
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
