#!/usr/bin/env python3
"""Times this checkout's ``lp_gain``, ``contract_edges``, ``hem_propose`` and
``mapcost`` kernels against an earlier design of the same four, in one
process on one NVIDIA GPU.

    python3 chip_kernel_ab.py --old OLD_CHECKOUT [--out FILE.json]

``OLD_CHECKOUT`` is the root of an earlier checkout of this repository, for
example the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Its kernels package (``src/repro_torch/kernels``) is
loaded under another name, its library built from its four sources alone
with its own nvcc flags, and its four wrappers (``lp_gain_cuda``,
``contract_edges_cuda``, ``hem_propose_cuda``, ``mapcost_cuda``) are put in
place of this checkout's in ``kernels.ops``, so an earlier design is timed
with its own wrapper (e.g. a host-side sum of partials); everything else
runs from this checkout. The wrappers of both must take the same
arguments.

1. Runs ``chip_smoke.py``'s mapping main path (``gen_rgg(2**20, seed=0)`` on
   4:8:6, ``SharedMapConfig()``, ``ell`` on the card) with every launch of
   the mapping kernels timed behind a spin on the card
   (``chip_smoke._timed_main_path``), first with the old kernels, then with
   this checkout's, and requires the same ``pe_of`` from both. Prints each
   kernel's summed ms, by padded N.
2. On the inputs this checkout's run captured at each padded N (2^20, 2^18,
   2^15: ``contract_edges``, ``lp_gain``, and ``hem_propose`` in matching
   rounds 1 and 3) and on the main path's ``mapcost`` call, and for
   ``mapcost`` also on a random mapping of the padded root graph (as
   ``chip_smoke.py`` times it), holds both designs against the plain
   version (bitwise; ``mapcost`` within rtol 1e-5) and times each twice,
   in turns (old, new, new, old), each timing the median of 20 event-timed
   runs (50 below 2^19 rows or edges) without the spin (``ms``, as
   ``chip_smoke.py``'s ``ms``) and with it (``device_ms``).
3. Prints one JSON object as the last line and writes it to ``--out``.

It exits with code 2 without a CUDA device. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = ("lp_gain.cu", "contract_edges.cu", "hem_propose.cu", "mapcost.cu")
ENTRIES = ("lp_gain_f32", "contract_edges_f32", "hem_propose_f32", "mapcost_f32")
WRAPPERS = {"lp_gain_cuda": "lp_gain", "contract_edges_cuda": "coarsen_kernels",
            "hem_propose_cuda": "coarsen_kernels", "mapcost_cuda": "mapcost"}


def _load_old(old_root: Path, build_dir: Path) -> dict:
    """The earlier checkout's kernels package as ``ab_old_kernels``, its
    library built from the four sources alone; returns its wrappers."""
    kdir = old_root / "src/repro_torch/kernels"
    spec = importlib.util.spec_from_file_location(
        "ab_old_kernels", kdir / "__init__.py", submodule_search_locations=[str(kdir)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    old_build = importlib.import_module("ab_old_kernels._build")
    old_build.BUILD_DIR = build_dir
    old_build._sources = lambda: [kdir / "csrc" / s for s in SOURCES]
    old_build._SIGNATURES = {k: v for k, v in old_build._SIGNATURES.items() if k in ENTRIES}
    old_build.library()
    for s in SOURCES:
        for line in old_build.ptxas_report(s):
            print(f"ptxas old {s}: {line}", flush=True)
    return {name: getattr(importlib.import_module(f"ab_old_kernels.{mod}"), name)
            for name, mod in WRAPPERS.items()}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


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
    from repro_torch.core.hierarchy import _tables, parse_hierarchy
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    designs = {"old": _load_old(args.old.resolve(), _build.BUILD_DIR / "ab_old"),
               "new": {name: getattr(kops, name) for name in WRAPPERS}}

    def use(name):
        for fn_name, fn in designs[name].items():
            setattr(kops, fn_name, fn)

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

    # (key, case, captured arguments, exact)
    shapes = []
    for n in sorted(caps["contract_edges"], reverse=True):
        shapes.append((f"contract_edges@{n}", cs._contract_case, caps["contract_edges"][n], True))
    for n in sorted(caps["lp_gain"], reverse=True):
        shapes.append((f"lp_gain@{n}", cs._lp_gain_case, caps["lp_gain"][n], True))
    for n in sorted(caps["hem_propose"], reverse=True):
        for rnd in (1, 3):
            shapes.append((f"hem_propose@{n}/round{rnd}", cs._hem_case,
                           caps["hem_propose"][n][rnd - 1], True))
    (m_args,) = caps["mapcost"].values()
    shapes.append(("mapcost@main_path_pe_of", cs._mapcost_case, m_args, False))
    gp = G.repad_device(g, cs.RGG_N, 1 << (int(g.m) - 1).bit_length())
    gen = torch.Generator(device="cpu").manual_seed(0)
    pe_rand = torch.randint(0, h.k, (gp.N,), generator=gen, dtype=torch.int32).to(dev)
    shapes.append(("mapcost@pe_rand", cs._mapcost_case,
                   (gp.rows, gp.cols, gp.ewgt, pe_rand, *_tables(h, dev)), False))

    order = list(designs) + list(designs)[::-1]
    for key, case, cargs, exact in shapes:
        label, kernel, plain, kargs, nbytes, flops, _ = case(cargs)
        bound_ms, bound_by = cs._bound(nbytes, flops)
        want = _as_tuple(plain(*kargs))
        for name in designs:
            use(name)
            got = _as_tuple(kernel(*kargs))
            ok = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) if exact
                     else torch.allclose(a, b, rtol=1e-5, atol=0.0) for a, b in zip(got, want))
            if not ok:
                raise AssertionError(f"{key} [{name}] at {label}: disagrees with the plain version")
        reps = 50 if kargs[0].shape[0] < 2**19 else 20
        rec = {"label": label, "bound_ms": bound_ms, "bound_by": bound_by,
               "ms": {k: [] for k in designs}, "device_ms": {k: [] for k in designs}}
        for name in order:
            use(name)
            rec["ms"][name].append(cs._time_ms(lambda: kernel(*kargs), reps, 3))
            rec["device_ms"][name].append(
                cs._time_ms(lambda: kernel(*kargs), reps, 3, pad=True))
        result["shapes"][key] = rec
        print(f"{key} at {label}, {'bitwise' if exact else 'rtol 1e-5'} under both designs; "
              f"bound {bound_ms:.5f} ms ({bound_by}); ms, device_ms (two timings each): "
              + "; ".join(f"{k} {rec['ms'][k][0]:.5f}/{rec['ms'][k][1]:.5f}, "
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
