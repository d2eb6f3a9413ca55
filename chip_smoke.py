#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and prints the build time and ptxas's
   report (registers, shared memory, spills) for every kernel but
   ``gather_rows``.
2. Holds every kernel against its plain PyTorch version on the card, on
   inputs captured from the main path at its top-level shapes, and times
   both (CUDA events, median of several runs after a warm-up; the
   kernel also behind a spin on the card, ``device_ms``, see PAD_CYCLES);
   ``contract_edges``, ``lp_gain``, ``hem_propose`` and ``mapcost`` follow
   in phase 6 at the main path's own inputs.
3. Runs ``shared_map`` on small unit-weight instances on the card and on
   the CPU, with the refinement backend pinned to ``ell`` and to ``xla`` on
   both sides, and requires the same ``pe_of``; then the same instances
   with float weights (``graph.float_weights``): two card runs give one
   ``pe_of`` and one J, and the card's ``pe_of`` is compared with the
   CPU's.
4. Runs the other strategies on the card at ``gen_rgg(2**16)`` on 4:8:6:
   ``device`` equals its ``resident=False`` twin with one array fetch,
   ``layer`` runs, ``queue`` equals ``naive``. The ``device`` strategy on
   four levels (2:2:2:2), whose children at depth 3 reach the ``powf``
   kernel, equals the CPU's on grid 32x32 and rgg 2000; the ``powf``
   kernel is held bitwise against its plain version.
5. Profiles the root's partition call under ``ell`` and under ``xla``
   (device busy share, device ops, top kernels), each also with the
   parent's float sums by label (``index_add_``, atomics) in place of
   ``graph.label_sums``/``row_label_sums``, so that the cost of the
   fixed-order sums shows.
6. Runs the main path at a real size: ``gen_rgg(2**20, seed=0)`` on the
   hierarchy 4:8:6 with D = 1:10:100 (k = 192) and ``SharedMapConfig()``
   (``auto`` = ``ell`` on the card) and with ``xla`` pinned for comparison,
   twice each in turns (ell, xla, xla, ell). Every path reads the launch
   counts around its run. A fifth run under ``ell`` puts a CUDA event pair
   around every launch of the five mapping kernels and prints, per kernel
   and per padded size, the launches, the summed ms and the median ms per
   launch. It captures, at each padded size of a partition call (2^20,
   2^18, 2^15), the inputs of the first ``contract_edges`` call of the
   first partition call there, of the last ``lp_gain`` call of the last
   one, and of the first and third ``hem_propose`` calls (rounds 1 and 3
   of the first coarsening level there); each is held bitwise against its
   plain version and timed at all three. The main path's own ``mapcost``
   call (J of the final ``pe_of``) is held and timed too.
7. The serving path: the llama3.2 smoke config's prefill on the card
   against the CPU, then llama3.2-3b at full width (28 layers, d_model
   3072, random weights from a seeded ``torch.Generator``). ``prefill_fn`` on
   B = 4 x S = 4096 tokens (the ``prefill_32k`` cell cut to fit the smoke's
   time) through the flash kernel (28 launches) and through the dense
   ``_sdpa`` path, whose last-position logits must agree; the KV-cache
   ``Engine`` answers 4 prompts of 32 tokens with 64 greedy steps, and its
   last prompt-step logits must agree with a flash prefill of the prompts.
   One flash prefill is profiled (device busy share, the kernel's share),
   and four engine steps (device ops per step).
   The flash kernel is held against its plain version (``flash_bshd_ref``)
   on the q [B, S, H, D] and k/v [B, S, Hkv, D] of layer 0 of that prefill,
   as the model hands them over, and on small shapes: f32, and bf16 at D
   12, 64 and 256 with three query heads per KV head.
8. Prints one JSON line with every kernel's numbers, then the contract's
   last line. Any failed check raises, and the script exits non-zero.

It needs a CUDA device and the repository's ``src/``; without either it
exits with code 2 and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
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
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 on the tensor cores, dense

RGG_N = 2**20
RGG_N_STRATEGIES = 2**16   # the device strategy keeps every lane at the root's shape
HIERARCHY = ("4:8:6", "1:10:100")
TPU_KERNELS = {   # the TPU kernel each CUDA kernel replaces (wrapper def line)
    "gather_rows": "src/repro/kernels/split.py:34",
    "hem_propose": "src/repro/kernels/coarsen_kernels.py:59",
    "contract_edges": "src/repro/kernels/coarsen_kernels.py:98",
    "mapcost": "src/repro/kernels/mapcost.py:52",
    "lp_gain": "src/repro/kernels/lp_gain.py:51",
    "flash_attention": "src/repro/kernels/flashattn.py:74",
}
ARCH = "llama3.2-3b"
PREFILL_B, PREFILL_S = 4, 4096     # prefill_32k (B 32, S 32768) cut to fit the smoke
ENGINE_B, ENGINE_P, ENGINE_STEPS, ENGINE_MAX_LEN = 4, 32, 64, 128
# bf16 logits of two attention routes (flash: f32 softmax and PV, one
# rounding; _sdpa: bf16 probabilities) after 28 layers; the reference's own
# decode-vs-forward test allows the same at its smoke size
# (tests/test_models.py:87).
LOGITS_ATOL, LOGITS_RTOL = 0.15, 0.1
# flash against its plain version, as (rtol, atol). Both compute in f32 and
# round the output once to the input type, so in bf16 they may differ by one
# rounding step: rtol 2^-7 is one bf16 ulp of the value, and the atol only
# covers f32 summation order near zero. In f32 the outputs of S = 300
# standard-normal slices are of order 0.1, and 2e-5 is summation order.
FLASH_TOL = {"bfloat16": (2.0**-7, 1e-4), "float32": (0.0, 2e-5)}


# With ``pad``, a spin of this many cycles (about 1 ms) runs on the card
# before the first event of a timed call, so the host has queued the call and
# its second event before the card reaches the first: the pair then reads the
# card's time for the call alone, not the host's cost of issuing it (tens of
# microseconds, more than a small kernel takes). The kernels line's ``ms`` is
# timed without it, as in earlier runs; ``device_ms`` with it.
PAD_CYCLES = 2_000_000


def _time_ms(fn, reps: int = 10, warmup: int = 2, pad: bool = False) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` event-timed runs, each
    behind a spin of PAD_CYCLES on the card if ``pad``."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if pad:
            torch.cuda._sleep(PAD_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(nbytes: int, flops: int, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _capture(module, name: str, store: list):
    """Wrap ``module.name`` so each call's arguments are kept in ``store``."""
    orig = getattr(module, name)

    def rec(*args):
        store.append(args)
        return orig(*args)
    setattr(module, name, rec)
    return orig


MAPPING_KERNELS = ("gather_rows", "hem_propose", "contract_edges", "mapcost", "lp_gain")


def _timed_main_path(run, kops):
    """Run ``run()`` with a CUDA event pair around every launch of the
    mapping kernels (the routes in ``kops``), each behind a spin so that the
    pair reads the card's time for the launch (see PAD_CYCLES). Returns
    ``(out, times, captures)``: ``times[kernel][n]`` lists each launch's ms
    by the leading size n of its first input (the padded N for the ELL
    kernels, M for ``mapcost``), and ``captures[kernel][n]`` the arguments
    of the first ``contract_edges`` call at n (that of the first partition
    call there), of the last ``lp_gain`` call at n (the last partition
    call's; its labels cloned), of the first three ``hem_propose`` calls at
    n (the three matching rounds of the first coarsening level there), and
    of the last ``mapcost`` call (the J of the final mapping)."""
    import torch
    marks, caps = [], {"contract_edges": {}, "lp_gain": {}, "hem_propose": {}, "mapcost": {}}
    saved = {name: getattr(kops, name) for name in MAPPING_KERNELS}

    def hook(name, orig):
        def timed(*args):
            n = int(args[0].shape[0])
            if name == "contract_edges":
                caps[name].setdefault(n, args)
            elif name == "lp_gain":
                caps[name][n] = (args[0], args[1], args[2].clone(), args[3])
            elif name == "hem_propose" and len(caps[name].setdefault(n, [])) < 3:
                caps[name][n].append(args)
            elif name == "mapcost":
                caps[name][n] = args
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(PAD_CYCLES)
            a.record()
            out = orig(*args)
            b.record()
            marks.append((name, n, a, b))
            return out
        return timed
    for name, orig in saved.items():
        setattr(kops, name, hook(name, orig))
    try:
        out = run()
    finally:
        for name, orig in saved.items():
            setattr(kops, name, orig)
    torch.cuda.synchronize()
    times: dict = {}
    for name, n, a, b in marks:
        times.setdefault(name, {}).setdefault(n, []).append(a.elapsed_time(b))
    return out, times, caps


# The cases below call each kernel's wrapper through ``kernels.ops`` at call
# time, so that chip_kernel_ab.py can put an earlier design's wrapper there.

def _contract_case(args):
    """A captured ``contract_edges`` call as ``(label, kernel, plain, args,
    bytes, operations, library)``. Bytes: each input read once, each output
    written once. Operations: what this data needs, one compare-add for
    each pair of live slots of a row."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    cand, candw = args
    N, D2 = cand.shape
    live = (cand != N).sum(1, dtype=torch.int64)
    return (f"[{N}, {D2}], {int(live.sum())} live slots",
            lambda a, b: kops.contract_edges_cuda(a, b, N),
            lambda a, b: ref.contract_edges_ref(a, b, N), (cand, candw),
            16 * N * D2 + 4 * N, int((live * live).sum()), None)


def _lp_gain_case(args):
    """A captured ``lp_gain`` call, as :func:`_contract_case`. Operations:
    one add per live slot and restart. Library: ``scatter_add_`` of conn."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    adj, adw, parts, k = args
    N, DEG = adj.shape
    R = parts.shape[0]
    nbr = torch.where(adj < N, parts[:, adj.clamp(0, N - 1)], 0).long()
    live = int((adj < N).sum())
    return (f"N={N} DEG={DEG} R={R} k={k}, {live} live slots",
            lambda a, w, p: kops.lp_gain_cuda(a, w, p, k),
            lambda a, w, p: ref.lp_gain_ref(a, w, p, k), (adj, adw, parts),
            8 * N * DEG + 4 * R * N + R * N * (4 * k + 8), R * live,
            lambda a, w, p: torch.zeros(R, N, k, device=a.device).scatter_add_(
                2, nbr, w.expand(R, N, DEG)))


def _hem_case(args):
    """A captured ``hem_propose`` call, as :func:`_contract_case`. Bytes:
    the ids, weights and jitters of every unmatched row (a matched row
    proposes N from its flag alone), and every row's flag and proposal.
    Operations: one score (a multiply, an add and a fused multiply-add) per
    valid slot."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    adj, adw, jit, matched = args
    N, DEG = adj.shape
    free = matched == 0
    u = torch.arange(N, device=adj.device)[:, None]
    valid = (free[:, None] & (adj < N) & (adj != u)
             & (matched[adj.clamp(0, N - 1)] == 0))
    live = int(free.sum())
    return (f"[{N}, {DEG}], {live} unmatched rows, {int(valid.sum())} valid slots",
            lambda *a: kops.hem_propose_cuda(*a), ref.hem_propose_ref, args,
            12 * DEG * live + 8 * N, 4 * int(valid.sum()), None)


def _mapcost_case(args):
    """A ``mapcost`` call, as :func:`_contract_case`. Bytes: the three edge
    arrays and the PE ids, each read once. Operations: a multiply and an
    add per edge."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    rows, cols, ewgt, pe, gb, dv = args
    M, N = rows.shape[0], pe.shape[0]
    same = float((pe[rows.clamp(0, N - 1)] == pe[cols.clamp(0, N - 1)]).float().mean())
    return (f"M={M}, N={N}, l={gb.shape[0]}, {same:.4f} of the edge slots within one PE",
            lambda *a: kops.mapcost_cuda(*a), ref.mapcost_ref, args,
            12 * M + 4 * N, 2 * M, None)


@contextlib.contextmanager
def _atomic_sums():
    """Run with the parent's float sums by label, ``index_add_`` (atomics on
    the card), in place of ``graph.label_sums`` and ``graph.row_label_sums``
    in every module that calls them."""
    import torch
    from repro_torch.core import graph, initial, refine

    def sums(slot, ok, w, size):   # dropped entries spread over 4096 spare slots
        spare = size + torch.arange(slot.shape[-1], device=slot.device) % 4096
        out = torch.zeros(size + 4096, dtype=w.dtype, device=slot.device)
        out.index_add_(0, torch.where(ok, slot, spare).reshape(-1),
                       w.expand(slot.shape).reshape(-1))
        return out[:size]

    def label_sums(labels, w, k):
        R = labels.shape[0]
        lane = torch.arange(R, device=labels.device)[:, None] * k
        return sums(lane + labels, (labels >= 0) & (labels < k), w, R * k).view(R, k)

    def row_sums(g, labels, w, k):
        R, M = labels.shape
        lane = torch.arange(R, device=g.device)[:, None] * (g.N * k)
        ok = (labels >= 0) & (labels < k) & (torch.arange(M, device=g.device) < g.m)
        return sums(lane + g.rows.long() * k + labels, ok, w, R * g.N * k).view(R, g.N, k)
    swaps = [(graph, "label_sums", label_sums), (refine, "label_sums", label_sums),
             (refine, "row_label_sums", row_sums), (initial, "row_label_sums", row_sums)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _run_path(name, fn, expect, _build):
    """Drive one path with every launch count set to 0 just before it and
    read just after; fail if a kernel of the path never launched."""
    import torch
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels of the path never launched: {missing}")
    return out, seconds, launches


def _flash_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the causal / window mask keeps in one [S, S]
    slice: the work attention needs, whatever the kernel's tiling."""
    pairs = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += hi - lo
    return pairs


def _serving_path(dev, check, _build) -> int:
    """Phase 7: llama3.2-3b prefill (flash and _sdpa), the Engine, a profile
    and the flash kernel against its plain version. Returns the flash
    launches of one full-width prefill."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.flashattn import flash_attention_cuda
    from repro_torch.models import model as MM
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.serve.engine import Engine

    # the smoke config on the card against the CPU's plain route
    small = get_smoke_config(ARCH)
    p_cpu = MM.init_fn(small, torch.Generator(device="cpu").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, small.vocab_size, (2, 300)))
    want = MM.prefill_fn(small, p_cpu, {"tokens": toks}, ShardCtx(use_flash=True))
    got = MM.prefill_fn(small, p_cpu.to(dev), {"tokens": toks.to(dev)}, ShardCtx(use_flash=True))
    diff = float((got.cpu().float() - want.float()).abs().max())
    print(f"{small.name} prefill_fn flash B=2 S=300: card against CPU max abs diff "
          f"{diff:.4g}; atol {LOGITS_ATOL} rtol {LOGITS_RTOL}", flush=True)
    if not torch.allclose(got.cpu().float(), want.float(), atol=LOGITS_ATOL, rtol=LOGITS_RTOL):
        raise AssertionError("smoke-config prefill: the card disagrees with the CPU")

    cfg = get_config(ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = MM.init_fn(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params.parameters())
    print(f"{ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; {n_params} params (f32) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S)),
                             device=dev)
    flash, dense = ShardCtx(use_flash=True), ShardCtx()
    MM.prefill_fn(cfg, params, {"tokens": tokens[:, :256]}, flash)   # warm-up

    captured = []
    orig = kops.flash_attention_cuda

    def first_call(q, k, v, causal, window):   # layer 0's q/k/v, kept as handed over
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), causal, window))
        return orig(q, k, v, causal, window)

    def prefill(ctx):
        torch.cuda.reset_peak_memory_stats()
        out = MM.prefill_fn(cfg, params, {"tokens": tokens}, ctx)
        return out, torch.cuda.max_memory_allocated()
    kops.flash_attention_cuda = first_call
    try:
        (lf, peak_f), t_f, ln_f = _run_path("prefill, flash", lambda: prefill(flash),
                                            ["flash_attention"], _build)
    finally:
        kops.flash_attention_cuda = orig
    (ld, peak_d), t_d, ln_d = _run_path("prefill, _sdpa", lambda: prefill(dense), [], _build)
    (lf2, _), t_f2, _ = _run_path("prefill, flash, second run", lambda: prefill(flash),
                                  ["flash_attention"], _build)
    if ln_f["flash_attention"] != cfg.num_layers or ln_d["flash_attention"] != 0:
        raise AssertionError(f"flash launches {ln_f['flash_attention']} (flash) and "
                             f"{ln_d['flash_attention']} (_sdpa), expected "
                             f"{cfg.num_layers} and 0")
    ntok = PREFILL_B * PREFILL_S
    for label, t, pk in (("flash", t_f, peak_f), ("flash, second run", t_f2, None),
                         ("_sdpa", t_d, peak_d)):
        print(f"prefill_fn {ARCH} B={PREFILL_B} S={PREFILL_S} (the prefill_32k cell "
              f"cut from B=32, S=32768 for the smoke's time limit), {label}: {t:.3f} s, "
              f"{ntok / t:.0f} tokens/s" + (f", peak memory {pk} B" if pk else ""),
              flush=True)
    print(f"prefill flash launches {ln_f['flash_attention']} (one per layer)", flush=True)
    for a, b, what in ((lf, ld, "_sdpa"), (lf, lf2, "a second flash run")):
        if a.shape != (PREFILL_B, 1, cfg.vocab_size) or not torch.isfinite(a.float()).all():
            raise AssertionError(f"prefill logits: shape {tuple(a.shape)} or not finite")
        diff = float((a.float() - b.float()).abs().max())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"prefill logits, flash against {what}: max abs diff {diff:.4g} "
              f"(|logits| max {float(a.float().abs().max()):.4g}), argmax agreement "
              f"{same:.2f}; atol {LOGITS_ATOL} rtol {LOGITS_RTOL}", flush=True)
        if not torch.allclose(a.float(), b.float(), atol=LOGITS_ATOL, rtol=LOGITS_RTOL):
            raise AssertionError(f"prefill logits: flash and {what} disagree")
    del lf, ld, lf2
    torch.cuda.empty_cache()

    # the KV-cache engine: prompts stepped through decode_fn, then greedy steps
    prompts = rng.integers(0, cfg.vocab_size, (ENGINE_B, ENGINE_P))
    eng = Engine(cfg, params, max_len=ENGINE_MAX_LEN)
    prompt_logits = []
    orig_decode = MM.decode_fn

    def keep_last_prompt_step(cfg_, p, t, cache, pos, ctx=None):
        out = orig_decode(cfg_, p, t, cache, pos, ctx)
        if pos == ENGINE_P - 1:
            prompt_logits.append(out[0].clone())
        return out
    MM.decode_fn = keep_last_prompt_step
    try:
        (gen_toks, stats), t_e, _ = _run_path(
            "engine", lambda: eng.generate(prompts, ENGINE_STEPS), [], _build)
    finally:
        MM.decode_fn = orig_decode
    if gen_toks.shape != (ENGINE_B, ENGINE_STEPS) or not (
            (gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all():
        raise AssertionError(f"engine tokens: shape {gen_toks.shape} or out of range")
    print(f"engine {ARCH} B={ENGINE_B} prompt {ENGINE_P} steps {ENGINE_STEPS} max_len "
          f"{ENGINE_MAX_LEN}: prompt (stepped) {stats.prefill_s:.3f} s, decode "
          f"{stats.decode_s:.3f} s, {stats.tok_per_s:.1f} tok/s, {t_e:.3f} s in all; "
          f"first tokens {gen_toks[:, :6].tolist()}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:   # 2 prompt + 2 decode steps
        eng.generate(prompts[:, :2], 2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profile: engine, 4 decode_fn steps at B={ENGINE_B}: wall {wall:.3f} s under "
          f"the profiler, device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}%), {sum(e.count for e in events) / 4:.0f} "
          f"device ops per step", flush=True)
    del eng, prof, events
    torch.cuda.empty_cache()
    pf = MM.prefill_fn(cfg, params, {"tokens": torch.as_tensor(prompts, device=dev)}, flash)
    el = prompt_logits[0]
    diff = float((pf.float() - el.float()).abs().max())
    same = float((pf.argmax(-1) == el.argmax(-1)).float().mean())
    print(f"flash prefill_fn against the engine's last prompt step ({ENGINE_B} x "
          f"{ENGINE_P} tokens): max abs diff {diff:.4g}, argmax agreement {same:.2f}; "
          f"atol {LOGITS_ATOL} rtol {LOGITS_RTOL}", flush=True)
    if not torch.allclose(pf.float(), el.float(), atol=LOGITS_ATOL, rtol=LOGITS_RTOL):
        raise AssertionError("flash prefill and the engine's prompt logits disagree")

    # one flash prefill, profiled: CUDA-side events only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        MM.prefill_fn(cfg, params, {"tokens": tokens}, flash)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    flash_us = sum(e.self_device_time_total for e in events if "flash_kernel" in e.key)
    print(f"profile: prefill_fn flash B={PREFILL_B} S={PREFILL_S}: wall {wall:.3f} s "
          f"under the profiler, device busy {busy_us / 1e6:.3f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}%), flash kernel {flash_us / 1e6:.3f} s "
          f"({100 * flash_us / max(busy_us, 1):.1f}% of device time), "
          f"{sum(e.count for e in events)} device ops", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile:   {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)
    del prof, events, params
    torch.cuda.empty_cache()

    # the flash kernel against its plain version: small shapes (f32; bf16
    # with three query heads per KV head), then the prefill's layer-0 q/k/v
    # (timed; the row of the kernels line)
    gen = torch.Generator(device="cpu").manual_seed(1)
    small_cases = [("float32", D, 2, 2) for D in (12, 64)]
    small_cases += [("bfloat16", D, 6, 2) for D in (12, 64, 256)]
    for dtype, D, H, Hkv in small_cases:
        rtol, atol = FLASH_TOL[dtype]
        for causal, window in ((False, 0), (False, 64), (True, 64), (True, 0)):
            q, k, v = (torch.randn(2, 300, h, D, generator=gen).to(dev, getattr(torch, dtype))
                       for h in (H, Hkv, Hkv))
            got = flash_attention_cuda(q, k, v, causal, window)
            want = ref.flash_bshd_ref(q, k, v, causal, window)
            err = float((got.float() - want.float()).abs().max())
            print(f"flash_attention {dtype} B=2 S=300 H={H} Hkv={Hkv} D={D} causal={causal} "
                  f"window={window}: max abs err {err:.3g} (rtol {rtol:.4g} atol {atol})",
                  flush=True)
            if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
                raise AssertionError("flash_attention disagrees with its plain version")
    q, k, v, causal, window = captured[0]
    B_, S, H_, D = q.shape
    Hkv = k.shape[2]
    print(f"flash_attention at the prefill's layer-0 q/k/v: q {list(q.shape)} k/v "
          f"{list(k.shape)} {q.dtype} causal={causal} window={window}, read in place",
          flush=True)
    pairs = _flash_pairs(S, causal, window)
    med = float(ref.flash_bshd_ref(q, k, v, causal, window).float().abs().median())
    rtol, atol = FLASH_TOL["bfloat16"]
    print(f"flash_attention tolerance: rtol {rtol:.4g} atol {atol:.4g}, median |o| "
          f"{med:.4g} (allowed there {atol + rtol * med:.3g}); {pairs} (query, key) "
          f"pairs per slice kept by the mask", flush=True)
    # the yardstick: SDPA on the expanded, contiguous [B, H, S, D] tensors,
    # made here, outside the timed region
    rep = H_ // Hkv
    sdpa_in = tuple(x.repeat_interleave(n, dim=2).transpose(1, 2).contiguous()
                    for x, n in ((q, 1), (k, rep), (v, rep)))
    check("flash_attention", lambda a, b, c: flash_attention_cuda(a, b, c, causal, window),
          lambda a, b, c: ref.flash_bshd_ref(a, b, c, causal, window), (q, k, v), False,
          (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
          4 * B_ * H_ * pairs * D,
          library=lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
              a, b, c, is_causal=True),
          library_args=sdpa_in, rtol=rtol, atol=atol, ops_per_s=BF16_OPS_PER_S)
    return ln_f["flash_attention"]


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
    from repro_torch.core import hierarchy as H
    from repro_torch.core import multisection as MS
    from repro_torch.core.api import SharedMapConfig, shared_map, shared_map_direct
    from repro_torch.core.hierarchy import _tables, parse_hierarchy
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.core.partition import num_levels, partition
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.coarsen_kernels import hem_propose_cuda
    from repro_torch.kernels.powf import near_midpoint, powf_cuda, powf_ref
    from repro_torch.kernels.split import gather_rows_cuda

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # the default; f32 products in f32
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
    for source in ("flash_attention.cu", "lp_gain.cu", "contract_edges.cu", "hem_propose.cu",
                   "mapcost.cu", "powf.cu"):
        for line in _build.ptxas_report(source):
            print(f"ptxas {source}: {line}", flush=True)
    smem = {d: _build.library().flash_attention_bf16_smem(d) for d in (64, 128, 256)}
    print(f"flash_kernel_wgmma dynamic shared memory per block, by D: {smem} B "
          f"(ptxas counts only static shared memory)", flush=True)

    # ---- the main path's graph, at its top-level padded shapes ------------
    t0 = time.perf_counter()
    g = G.gen_rgg(RGG_N, seed=0, device=dev)
    n, m = int(g.n), int(g.m)
    N0, M0 = 1 << (n - 1).bit_length(), 1 << (m - 1).bit_length()
    gp = G.repad_device(g, N0, M0)
    h = parse_hierarchy(*HIERARCHY)
    top = h.a[-1]
    lv = num_levels(N0, top)
    deg_root = G.default_ell_deg(1, (m + n - 1) // n)   # the planner's root cap
    over = int(((g.indptr[1:] - g.indptr[:-1]) > deg_root).sum())
    print(f"rgg n={n} m={m} padded N={N0} M={M0} built in "
          f"{time.perf_counter() - t0:.1f} s; hierarchy {h} k={h.k}; root call "
          f"k={top}, {lv} levels, ELL cap {deg_root}, {over} rows over the cap",
          flush=True)

    # ---- 2. every kernel against its plain version on the card ------------
    hem_in, gat_in = [], []
    saved = [_capture(C.kops, "hem_propose", hem_in),
             _capture(G.kops, "gather_rows", gat_in)]
    try:
        gc, _ = C.coarsen_once(gp, salt=138, ell_deg=deg_root)   # the root's level 0
        part = (torch.arange(N0, device=dev, dtype=torch.int64) * top // N0).to(torch.int32)
        sent = gp.n.clone()
        orig = torch.arange(N0, dtype=torch.int32, device=dev)
        G.split_blocks(gp, part, orig, top, sent)
    finally:
        C.kops.hem_propose, G.kops.gather_rows = saved
    del gc
    torch.cuda.synchronize()

    rows = []

    def check(name, kernel, plain, args, exact, nbytes, flops, library=None,
              library_args=None, rtol=0.0, atol=0.0, ops_per_s=F32_OPS_PER_S,
              record=True, label=""):
        """Hold ``kernel`` against ``plain`` on ``args`` and time both (and
        ``library``); the numbers join the kernels line if ``record``."""
        got = kernel(*args)
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, used = 0.0, 0.0   # used: the worst |a - b| / (atol + rtol |b|)
        for a, b in zip(got, want):
            if exact:
                ok = torch.equal(a.view(torch.int32), b.view(torch.int32))
            else:
                ok = torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol)
            if not ok:
                raise AssertionError(f"{name}: kernel disagrees with its plain version")
            if a.is_floating_point():
                d = (a.double() - b.double()).abs()
                err = max(err, float(d.max()))
                if not exact:
                    r = d / (atol + rtol * b.double().abs())
                    used = max(used, float(torch.where(d == 0, 0.0, r).max()))
        ms = _time_ms(lambda: kernel(*args))
        device_ms = _time_ms(lambda: kernel(*args), pad=True)
        plain_ms = _time_ms(lambda: plain(*args), reps=5, warmup=1)
        lib_args = args if library_args is None else library_args
        lib_ms = _time_ms(lambda: library(*lib_args)) if library else None
        bound_ms, bound_by = _bound(nbytes, flops, ops_per_s)
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": TPU_KERNELS[name], "launches": None,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
               "device_ms": device_ms}
        if record:
            rows.append(row)
        agree = ("bitwise" if exact else
                 f"rtol {rtol:.4g} atol {atol:.4g}, worst {used:.3g} of the allowed error")
        print(f"kernel {name}{label}: agrees ({agree}, max_abs_err {err:.3g}) "
              f"ms {ms:.4f} device_ms {device_ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.4f} "
              f"({bound_by}) library_ms {lib_ms}", flush=True)
        return row

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
    # hem_propose: the three matching rounds of the first coarsening level,
    # timed on the first
    for args in hem_in:
        if not torch.equal(hem_propose_cuda(*args), ref.hem_propose_ref(*args)):
            raise AssertionError("hem_propose: kernel disagrees with its plain version")
    label, kernel, plain, args, nbytes, flops, _ = _hem_case(hem_in[0])
    check("hem_propose", kernel, plain, args, True, nbytes, flops, label=f" at {label}")
    # mapcost on a random mapping of the root graph (no edge within one PE)
    gen = torch.Generator(device="cpu").manual_seed(0)
    pe_rand = torch.randint(0, h.k, (N0,), generator=gen, dtype=torch.int32).to(dev)
    gb, dv = _tables(h, dev)
    label, kernel, plain, args, nbytes, flops, _ = _mapcost_case(
        (gp.rows, gp.cols, gp.ewgt, pe_rand, gb, dv))
    check("mapcost", kernel, plain, args, False, nbytes, flops, rtol=1e-5,
          label=f" at pe_rand, {label}")
    js = [kernel(*args) for _ in range(5)]
    if not all(torch.equal(j.view(torch.int32), js[0].view(torch.int32)) for j in js):
        raise AssertionError("mapcost: five runs gave more than one J")
    print(f"mapcost: five runs on pe_rand give one J ({float(js[0])!r})", flush=True)
    del hem_in, gat_in, src, idx, args
    torch.cuda.empty_cache()

    # ---- 3. small instances: the card's pe_of equals the CPU's -------------
    small_h = parse_hierarchy("4:2", "1:10")
    for name, gs in (("grid 32x32", G.gen_grid(32, device="cpu")),
                     ("rgg 2000", G.gen_rgg(2000, seed=3, device="cpu"))):
        for backend in ("ell", "xla"):
            cfg = SharedMapConfig(backend=backend)
            a = shared_map(gs, small_h, cfg, device=dev)
            b = shared_map(gs, small_h, cfg, device="cpu")
            if not np.array_equal(a.pe_of, b.pe_of):
                raise AssertionError(f"{name}, {backend}: pe_of on the card differs "
                                     "from the CPU's")
            print(f"small {name} backend {backend}: pe_of equal on card and CPU, "
                  f"J {a.J} / {b.J}", flush=True)
            # float weights: two card runs give one pe_of and one J
            gf = G.float_weights(gs, seed=7)
            a, a2 = (shared_map(gf, small_h, cfg, device=dev) for _ in range(2))
            if not (np.array_equal(a.pe_of, a2.pe_of) and a.J == a2.J):
                raise AssertionError(f"{name} float weights, {backend}: two card runs "
                                     "differ")
            b = shared_map(gf, small_h, cfg, device="cpu")
            same = int((a.pe_of == b.pe_of).sum())
            with _atomic_sums():   # the parent's sums, for the record
                old = {shared_map(gf, small_h, cfg, device=dev).pe_of.tobytes()
                       for _ in range(3)}
            print(f"small {name} float weights backend {backend}: two card runs give one "
                  f"pe_of and J {a.J!r}; card against CPU: pe_of equal on {same} of "
                  f"{len(a.pe_of)} vertices, J {a.J!r} / {b.J!r}; with index_add_ (the "
                  f"parent's sums) {len(old)} distinct pe_of in 3 card runs", flush=True)

    # ---- 4. the other strategies on the card, at rgg 2^16 ------------------
    gsm = G.gen_rgg(RGG_N_STRATEGIES, seed=0, device=dev)
    every = list(MAPPING_KERNELS)
    strat = {}

    host_split = [k for k in every if k != "gather_rows"]   # split on the host

    def run_strategy(label, cfg, resident=None, expect=every, backend="ell"):
        def go():
            MS.reset_transfer_stats()
            res = shared_map_direct(gsm, h, cfg, resident=resident, device=dev)
            return res, MS.transfer_stats()
        (res, xfer), sec, launches = _run_path(label, go, expect, _build)
        if res.stats["backend"] != backend:
            raise AssertionError(f"{label}: backend {res.stats['backend']!r}")
        strat[label] = res
        print(f"strategy {label} rgg n={RGG_N_STRATEGIES} on {h}: {sec:.2f} s, "
              f"J {res.J}, partition calls {res.stats['partition_calls']}, array "
              f"fetches {xfer['d2h_array_fetches']}, launches {launches}", flush=True)
        return xfer
    run_strategy("bucket", SharedMapConfig())
    run_strategy("bucket, xla pinned", SharedMapConfig(backend="xla"),
                 expect=[k for k in every if k != "lp_gain"], backend="xla")
    xfer = run_strategy("device", SharedMapConfig(strategy="device"))
    if xfer["d2h_array_fetches"] != 1:
        raise AssertionError(f"device strategy fetched {xfer['d2h_array_fetches']} arrays")
    run_strategy("device resident=False", SharedMapConfig(strategy="device"), False,
                 host_split)
    if not np.array_equal(strat["device"].pe_of, strat["device resident=False"].pe_of):
        raise AssertionError("device strategy differs from its resident=False twin")
    run_strategy("layer", SharedMapConfig(strategy="layer"))
    run_strategy("naive", SharedMapConfig(strategy="naive"), expect=host_split)
    run_strategy("queue", SharedMapConfig(strategy="queue"), expect=host_split)
    if not np.array_equal(strat["queue"].pe_of, strat["naive"].pe_of):
        raise AssertionError("queue strategy differs from naive")
    if not np.array_equal(strat["bucket"].pe_of, strat["naive"].pe_of):
        raise AssertionError("bucket strategy differs from naive")
    print("strategies: device equals its twin with one array fetch; queue equals "
          "naive equals bucket", flush=True)
    del gsm, strat

    # the device strategy on four levels: its children at depth 3 reach powf
    # on the card; card against the CPU (which equals the reference)
    deep_h = parse_hierarchy("2:2:2:2", "1:10:100:1000")
    deep_cfg = SharedMapConfig(strategy="device", backend="ell")
    pow_powf = H._powf

    def torch_powf(x, depth):   # the parent's card route: torch's float32 pow
        if depth <= 2:
            return pow_powf(x, depth)
        return torch.pow(x, float(np.float32(1.0 / depth)))
    for name, gs in (("grid 32x32", G.gen_grid(32, device="cpu")),
                     ("rgg 2000", G.gen_rgg(2000, seed=3, device="cpu"))):
        a, _, ln = _run_path(f"device strategy {name} on {deep_h}",
                             lambda: shared_map_direct(gs, deep_h, deep_cfg, device=dev),
                             ["powf"], _build)
        b = shared_map_direct(gs, deep_h, deep_cfg, device="cpu")
        if not np.array_equal(a.pe_of, b.pe_of):
            raise AssertionError(f"device strategy, {name} on {deep_h}: the card's pe_of "
                                 "differs from the CPU's")
        H._powf = torch_powf
        try:
            old = shared_map_direct(gs, deep_h, deep_cfg, device=dev)
        finally:
            H._powf = pow_powf
        print(f"device strategy {name} on {deep_h}: pe_of equal on card and CPU, "
              f"{ln['powf']} powf launches, J {a.J} / {b.J}; with torch's pow (the "
              f"parent's card route) pe_of equal on {int((old.pe_of == b.pe_of).sum())} "
              f"of {len(b.pe_of)} vertices, J {old.J}", flush=True)
    rng = np.random.default_rng(0)
    lo, hi = (int(np.float32(v).view(np.uint32)) for v in (1.0, 8.0))
    x = rng.integers(lo, hi, 1 << 22).astype(np.uint32).view(np.float32)
    for d in (3, 4, 5):
        got = powf_cuda(torch.from_numpy(x).to(dev), 1.0 / d).cpu().numpy()
        want = powf_ref(x, 1.0 / d)
        bad = int((got.view(np.uint32) != want.view(np.uint32)).sum())
        if bad:
            raise AssertionError(f"powf kernel: {bad} of {x.size} values differ at d={d}")
        tp = torch.pow(torch.from_numpy(x).to(dev), float(np.float32(1.0 / d))).cpu().numpy()
        print(f"powf kernel d={d}: bitwise its plain version on {x.size} float32 in "
              f"[1, 8), {int(near_midpoint(x, 1.0 / d).sum())} of them near a rounding "
              f"midpoint; torch's float32 pow differs from it on "
              f"{int((tp.view(np.uint32) != want.view(np.uint32)).sum())}", flush=True)
    torch.cuda.empty_cache()

    # ---- 5. where the time goes: the root's partition call, profiled ------
    # Device time and op counts come from the CUDA-side events alone (kernels,
    # copies, sets): an aten op's own entry repeats the time of the kernels
    # it launched. A first, tiny profile takes the tracer's start-up cost.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    for backend, deg in (("ell", deg_root), ("xla", None)):
        parts = {}
        for sums, ctx in (("fixed-order label sums", contextlib.nullcontext),
                          ("index_add_ (the parent's)", _atomic_sums)):
            with ctx():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.profiler.profile(activities=acts) as prof:
                    parts[sums] = partition(gp, top, 0.03, lv, "eco", 0, backend, deg,
                                            device=dev)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(e.self_device_time_total for e in events)
            print(f"profile: root partition call (N={N0}, M={M0}, k={top}, {lv} levels, "
                  f"eco, {backend}, cap {deg}), sums by {sums}: wall {wall:.2f} s under the "
                  f"profiler, device busy {busy_us / 1e6:.3f} s "
                  f"({100 * busy_us / 1e6 / wall:.1f}%), {sum(e.count for e in events)} "
                  f"device ops", flush=True)
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
                print(f"profile:   {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
                      f"{e.key[:90]}", flush=True)
            del prof, events
        a, b = parts.values()
        print(f"profile: root partition call, {backend}: the two sums give "
              f"{'the same' if torch.equal(a, b) else 'another'} partition (unit weights: "
              f"every sum exact)", flush=True)

    # ---- 6. the main path at a real size, and xla pinned, in turns ---------
    def main_path(cfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = shared_map(g, h, cfg, device=dev)
        return out, torch.cuda.max_memory_allocated()
    no_lp = [k for k in every if k != "lp_gain"]
    (res, peak), t_first, launches = _run_path(
        "main path", lambda: main_path(SharedMapConfig()), every, _build)
    (res_x, peak_x), t_xla, launches_x = _run_path(
        "xla pinned", lambda: main_path(SharedMapConfig(backend="xla")), no_lp, _build)
    (res_x2, _), t_xla2, _ = _run_path(
        "xla pinned, second run", lambda: main_path(SharedMapConfig(backend="xla")),
        no_lp, _build)
    (res2, _), t_second, _ = _run_path(
        "main path, second run", lambda: main_path(SharedMapConfig()), every, _build)
    pe = res.pe_of
    rng = np.random.default_rng(0)
    j_rand = evaluate_J(g, h, rng.integers(0, h.k, n).astype(np.int32), device=dev)
    wv = g.vwgt[:n].cpu().numpy()
    for label, r, t1, t2, pk, ln in (("main path", res, t_first, t_second, peak, launches),
                                     ("xla pinned", res_x, t_xla, t_xla2, peak_x, launches_x)):
        bw = np.bincount(r.pe_of, weights=wv, minlength=h.k)
        print(f"{label} rgg n={n} on {h}: first {t1:.2f} s, second {t2:.2f} s, backend "
              f"{r.stats['backend']}, J {r.J}, J random {j_rand}, max/avg block "
              f"weight {bw.max() / bw.mean():.4f}, peak memory {pk} B, partition "
              f"calls {r.stats['partition_calls']}, launches {ln}", flush=True)
        print(f"{label} seconds per hierarchy level: "
              + ", ".join(f"{x['graphs']} graphs {x['seconds']:.2f} s"
                          for x in r.stats["levels"]), flush=True)
    if res.stats["backend"] != "ell":
        raise AssertionError(f"backend {res.stats['backend']!r}, expected 'ell'")
    if res_x.stats["backend"] != "xla":
        raise AssertionError(f"backend {res_x.stats['backend']!r}, expected 'xla'")
    if pe.shape != (n,) or pe.min() < 0 or pe.max() >= h.k:
        raise AssertionError("pe_of out of range")
    if not (np.array_equal(pe, res2.pe_of) and np.array_equal(res_x.pe_of, res_x2.pe_of)):
        raise AssertionError("two runs of one path gave different pe_of")
    for r in (res, res_x):
        if not r.J < j_rand:
            raise AssertionError(f"J {r.J} not below the random mapping's {j_rand}")

    # every launch of the mapping kernels timed, in a fifth run under ell;
    # contract_edges and lp_gain held and timed at the captured shapes
    (out_t, times, caps), t_timed, launches_t = _run_path(
        "main path, every launch timed",
        lambda: _timed_main_path(lambda: main_path(SharedMapConfig()), kops), every,
        _build)
    if not np.array_equal(out_t[0].pe_of, pe):
        raise AssertionError("the timed main path gave another pe_of")
    by_n = {}
    for name in MAPPING_KERNELS:
        per = times.get(name, {})
        if sum(map(len, per.values())) != launches_t[name]:
            raise AssertionError(f"{name}: {sum(map(len, per.values()))} timed calls, "
                                 f"{launches_t[name]} launches")
        by_n[name] = {str(n): {"launches": len(v), "ms": sum(v),
                               "ms_per_launch": statistics.median(v)}
                      for n, v in sorted(per.items(), reverse=True)}
        print(f"main path, every launch timed: {name} {launches_t[name]} launches, "
              f"{sum(map(sum, per.values())):.4f} ms in all; " + "; ".join(
                  f"n={n}: {d['launches']} launches, {d['ms']:.4f} ms, median "
                  f"{d['ms_per_launch']:.5f} ms" for n, d in by_n[name].items()), flush=True)
    print(f"main path, every launch timed: {t_timed:.2f} s end to end (with the "
          f"events' host cost), pe_of equal to the first run's", flush=True)
    for name, case in (("contract_edges", _contract_case), ("lp_gain", _lp_gain_case)):
        top_n = max(caps[name])
        for n in sorted(caps[name], reverse=True):   # the root's shape joins the line
            label, kernel, plain, args, nbytes, flops, lib = case(caps[name][n])
            row = check(name, kernel, plain, args, True, nbytes, flops, library=lib,
                        record=n == top_n, label=f" at {label}")
            by_n[name][str(n)].update(
                kernel_ms=row["ms"], device_ms=row["device_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                plain_ms=row["plain_ms"], library_ms=row["library_ms"])
    # hem_propose in rounds 1 and 3 of the first coarsening level at each N
    # (the line's row is phase 2's, the root's round 1)
    for n in sorted(caps["hem_propose"], reverse=True):
        calls = caps["hem_propose"][n]
        for rnd in (1, 3):
            label, kernel, plain, args, nbytes, flops, _ = _hem_case(calls[rnd - 1])
            row = check("hem_propose", kernel, plain, args, True, nbytes, flops,
                        record=False, label=f" round {rnd} at {label}")
            by_n["hem_propose"][str(n)][f"round{rnd}"] = {
                k: row[k] for k in ("ms", "device_ms", "bound_ms", "bound_by", "plain_ms")}
    # mapcost on the main path's own final pe_of
    (m_args,) = caps["mapcost"].values()
    label, kernel, plain, args, nbytes, flops, _ = _mapcost_case(m_args)
    mapcost_main = check("mapcost", kernel, plain, args, False, nbytes, flops, rtol=1e-5,
                         record=False, label=f" at the main path's pe_of, {label}")
    if float(kernel(*args)) != out_t[0].J:
        raise AssertionError("mapcost at the main path's pe_of gives another J")
    del g, gp, res, res2, res_x, res_x2, out_t, times, caps, m_args, args
    torch.cuda.empty_cache()

    # ---- 7. the serving path: llama3.2-3b at full width ---------------------
    flash_launches = _serving_path(dev, check, _build)

    # ---- 8. the kernels line and the contract's last line -------------------
    for r in rows:
        if r["name"] == "flash_attention":
            r["launches"] = flash_launches
            continue
        r["launches"] = launches[r["name"]]
        r["main_path_ms"] = sum(d["ms"] for d in by_n[r["name"]].values())
        r["by_n"] = by_n[r["name"]]
        if r["name"] == "mapcost":
            r["at_main_path_pe_of"] = {k: mapcost_main[k] for k in (
                "ms", "device_ms", "bound_ms", "bound_by", "plain_ms", "max_abs_err")}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
