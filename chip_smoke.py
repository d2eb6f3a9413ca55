#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and prints the build time.
2. Holds every kernel against its plain PyTorch version on the card, on
   inputs captured from the main path at its top-level shapes, and times
   both (CUDA events, median of several runs after a warm-up).
3. Runs ``shared_map`` on small unit-weight instances on the card and on
   the CPU and requires the same ``pe_of``.
4. Profiles the root's partition call (device busy share, top kernels).
5. Runs the main path at a real size: ``gen_rgg(2**20, seed=0)`` on the
   hierarchy 4:8:6 with D = 1:10:100 (k = 192) and ``SharedMapConfig()``,
   twice, with every kernel's launch count read around the first run.
6. Prints one JSON line with every kernel's numbers, then the contract's
   last line. Any failed check raises, and the script exits non-zero.

It needs a CUDA device and the repository's ``src/``; without either it
exits with code 2 and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

RGG_N = 2**20
HIERARCHY = ("4:8:6", "1:10:100")
TPU_KERNELS = {   # the TPU kernel each CUDA kernel replaces (wrapper def line)
    "gather_rows": "src/repro/kernels/split.py:34",
    "hem_propose": "src/repro/kernels/coarsen_kernels.py:59",
    "contract_edges": "src/repro/kernels/coarsen_kernels.py:98",
    "mapcost": "src/repro/kernels/mapcost.py:52",
}


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` event-timed runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _capture(module, name: str, store: list):
    """Wrap ``module.name`` so each call's arguments are kept in ``store``."""
    orig = getattr(module, name)

    def rec(*args):
        store.append(args)
        return orig(*args)
    setattr(module, name, rec)
    return orig


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run it from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.core import coarsen as C
    from repro_torch.core import graph as G
    from repro_torch.core.api import SharedMapConfig, shared_map
    from repro_torch.core.hierarchy import _tables, parse_hierarchy
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.coarsen_kernels import contract_edges_cuda, hem_propose_cuda
    from repro_torch.kernels.mapcost import mapcost_cuda
    from repro_torch.kernels.split import gather_rows_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_SECONDS:.1f} s)", flush=True)

    # ---- the main path's graph, at its top-level padded shapes ------------
    t0 = time.perf_counter()
    g = G.gen_rgg(RGG_N, seed=0, device=dev)
    n, m = int(g.n), int(g.m)
    N0, M0 = 1 << (n - 1).bit_length(), 1 << (m - 1).bit_length()
    gp = G.repad_device(g, N0, M0)
    h = parse_hierarchy(*HIERARCHY)
    print(f"rgg n={n} m={m} padded N={N0} M={M0} built in "
          f"{time.perf_counter() - t0:.1f} s; hierarchy {h} k={h.k}", flush=True)

    # ---- 2. every kernel against its plain version on the card ------------
    hem_in, con_in, gat_in = [], [], []
    saved = [_capture(C.kops, "hem_propose", hem_in),
             _capture(C.kops, "contract_edges", con_in),
             _capture(G.kops, "gather_rows", gat_in)]
    try:
        deg = G.default_ell_deg(N0, M0)
        gc, _ = C.coarsen_once(gp, salt=138, ell_deg=deg)   # level 0 of restart 0
        top = h.a[-1]
        part = (torch.arange(N0, device=dev, dtype=torch.int64) * top // N0).to(torch.int32)
        sent = gp.n.clone()
        orig = torch.arange(N0, dtype=torch.int32, device=dev)
        G.split_blocks(gp, part, orig, top, sent)
    finally:
        C.kops.hem_propose, C.kops.contract_edges, G.kops.gather_rows = saved
    del gc
    torch.cuda.synchronize()

    rows = []

    def check(name, kernel, plain, args, exact, nbytes, flops, library=None,
              rtol=None):
        got = kernel(*args)
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for a, b in zip(got, want):
            if exact:
                ok = torch.equal(a.view(torch.int32), b.view(torch.int32))
            else:
                ok = torch.allclose(a, b, rtol=rtol, atol=0.0)
            if not ok:
                raise AssertionError(f"{name}: kernel disagrees with its plain version")
            if a.is_floating_point():
                err = max(err, float((a.double() - b.double()).abs().max()))
        ms = _time_ms(lambda: kernel(*args))
        plain_ms = _time_ms(lambda: plain(*args), reps=5, warmup=1)
        lib_ms = _time_ms(lambda: library(*args)) if library else None
        bound_ms, bound_by = _bound(nbytes, flops)
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": TPU_KERNELS[name], "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        agree = "bitwise" if exact else f"rtol {rtol}"
        print(f"kernel {name}: agrees ({agree}, max_abs_err {err:.3g}) "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}) library_ms {lib_ms}", flush=True)

    # gather_rows: all five calls of the top-level split, timed on the
    # largest (the [top, M] edge-weight gather)
    for src, idx in gat_in:
        if not torch.equal(gather_rows_cuda(src, idx).view(torch.int32),
                           ref.gather_rows_ref(src, idx).view(torch.int32)):
            raise AssertionError("gather_rows: kernel disagrees with its plain version")
    src, idx = max(gat_in, key=lambda a: (a[1].numel(), a[0].dtype == torch.float32))
    check("gather_rows", gather_rows_cuda, ref.gather_rows_ref, (src, idx), True,
          4 * (src.numel() + 2 * idx.numel()), 0,
          library=lambda s, i: s[i])
    # hem_propose: the three matching rounds of the first coarsening level
    for args in hem_in:
        if not torch.equal(hem_propose_cuda(*args), ref.hem_propose_ref(*args)):
            raise AssertionError("hem_propose: kernel disagrees with its plain version")
    adj = hem_in[0][0]
    Nh, Dh = adj.shape
    check("hem_propose", hem_propose_cuda, ref.hem_propose_ref, hem_in[0], True,
          12 * Nh * Dh + 8 * Nh, 4 * Nh * Dh)
    cand, candw = con_in[0]
    Nc, D2 = cand.shape
    check("contract_edges", lambda a, b: contract_edges_cuda(a, b, Nc),
          lambda a, b: ref.contract_edges_ref(a, b, Nc), (cand, candw), True,
          16 * Nc * D2 + 4 * Nc, Nc * D2 * D2)
    gen = torch.Generator(device="cpu").manual_seed(0)
    pe_rand = torch.randint(0, h.k, (N0,), generator=gen, dtype=torch.int32).to(dev)
    gb, dv = _tables(h, dev)
    check("mapcost", mapcost_cuda, ref.mapcost_ref,
          (gp.rows, gp.cols, gp.ewgt, pe_rand, gb, dv), False,
          12 * M0 + 4 * N0, 2 * M0, rtol=1e-5)
    del hem_in, con_in, gat_in, src, idx, adj, cand, candw
    torch.cuda.empty_cache()

    # ---- 3. small instances: the card's pe_of equals the CPU's -------------
    small_h = parse_hierarchy("4:2", "1:10")
    for name, gs in (("grid 32x32", G.gen_grid(32, device="cpu")),
                     ("rgg 2000", G.gen_rgg(2000, seed=3, device="cpu"))):
        a = shared_map(gs, small_h, SharedMapConfig(), device=dev)
        b = shared_map(gs, small_h, SharedMapConfig(), device="cpu")
        if not np.array_equal(a.pe_of, b.pe_of):
            raise AssertionError(f"{name}: pe_of on the card differs from the CPU's")
        print(f"small {name}: pe_of equal on card and CPU, J {a.J} / {b.J}", flush=True)

    # ---- 4. where the time goes: the root's partition call, profiled ------
    from repro_torch.core.partition import num_levels, partition
    top = h.a[-1]
    lv = num_levels(N0, top)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        partition(gp, top, 0.03, lv, "eco", 0, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profile: root partition call (N={N0}, M={M0}, k={top}, {lv} levels, "
          f"eco): wall {wall:.2f} s under the profiler, device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{sum(e.count for e in events)} device ops", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)
    del prof, events

    # ---- 5. the main path at a real size -----------------------------------
    cfg = SharedMapConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = shared_map(g, h, cfg, device=dev)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    res2 = shared_map(g, h, cfg, device=dev)
    torch.cuda.synchronize()
    t_second = time.perf_counter() - t0
    pe = res.pe_of
    rng = np.random.default_rng(0)
    j_rand = evaluate_J(g, h, rng.integers(0, h.k, n).astype(np.int32), device=dev)
    bw = np.bincount(pe, weights=g.vwgt[:n].cpu().numpy(), minlength=h.k)
    print(f"main path rgg n={n} on {h}: first {t_first:.2f} s, second "
          f"{t_second:.2f} s, backend {res.stats['backend']}, J {res.J}, "
          f"J random {j_rand}, max/avg block weight {bw.max() / bw.mean():.4f}, "
          f"peak memory {peak} B, partition calls {res.stats['partition_calls']}, "
          f"launches {launches}", flush=True)
    print("main path seconds per hierarchy level (first run): "
          + ", ".join(f"{x['graphs']} graphs {x['seconds']:.2f} s"
                      for x in res.stats["levels"]), flush=True)
    if res.stats["backend"] != "xla":
        raise AssertionError(f"backend {res.stats['backend']!r}, expected 'xla'")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    if pe.shape != (n,) or pe.min() < 0 or pe.max() >= h.k:
        raise AssertionError("pe_of out of range")
    if not np.array_equal(pe, res2.pe_of):
        raise AssertionError("two runs of the main path gave different pe_of")
    if not res.J < j_rand:
        raise AssertionError(f"J {res.J} not below the random mapping's {j_rand}")

    # ---- 6. the kernels line and the contract's last line -------------------
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
