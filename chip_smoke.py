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
4. Runs the other strategies on the card at ``gen_rgg(2**15)`` (cut from
   2^16 for the smoke's time): ``device`` on 4:8:6 equals its
   ``resident=False`` twin with one array fetch; on 4:8 (cut from 4:8:6)
   ``layer`` runs, ``naive`` equals ``bucket``, ``queue`` equals
   ``naive``, and two ``xla`` runs give one ``pe_of``. The ``device`` strategy on four levels (2:2:2:2), whose
   children at depth 3 reach the ``powf`` kernel, fetches one array and
   equals the CPU's on grid 32x32 and rgg 2000; the ``powf``
   kernel is held bitwise against its plain version.
5. Profiles the root's partition call under ``ell`` and under ``xla``
   (device busy share, device ops, top kernels).
6. Runs the main path at a real size: ``gen_rgg(2**20, seed=0)`` on the
   hierarchy 4:8:6 with D = 1:10:100 (k = 192) and ``SharedMapConfig()``
   (``auto`` = ``ell`` on the card) and with ``xla`` pinned for comparison,
   in turns (ell, xla, ell; two ``xla`` runs are held against each other in
   phase 4); the second ``ell`` run is fed
   the graph's ``TaskGraph`` (its fingerprint and the seconds of
   ``from_graph`` and ``to_graph`` are printed). Its canonical CSR orders
   each row's neighbours otherwise than ``gen_rgg``'s, so its ``pe_of`` is
   held against the fourth run's, on that CSR as a ``Graph``. Every path
   reads the launch counts around its run. Both backends' J are held to
   MAIN_PATH_J and MAIN_PATH_J_XLA, and the widest level's wall (48 lanes
   at 2^15, one batched v-cycle), both runs' peak memory and the widest
   dispatch again on its captured inputs are printed: one
   ``batched_partition`` call profiled (device ops, busy share), one
   unprofiled (seconds, peak), then its lanes one at a time, all three
   with equal labels. The fourth run, under ``ell``,
   puts a CUDA event pair around every launch of the five mapping kernels
   and prints, per kernel and per (lanes, padded size) of a launch
   (1 x 2^20, 6 x 2^18, 48 x 2^15), the launches, the summed ms and the
   median ms per launch. It captures, at each of those, the inputs of the
   first ``contract_edges`` call there, of the last ``lp_gain`` call, and
   of the first and third ``hem_propose`` calls (rounds 1 and 3 of the
   first coarsening level there); each is held bitwise against its plain
   version and timed at all three, the batched shapes included. The main
   path's own ``mapcost`` call (J of the final ``pe_of``) is held and
   timed too.
7. The paper's quality comparison (the JAX package's
   ``benchmarks/run.py:quality_profiles``): on the small instances of
   phase 3 under ``ell`` and ``xla`` pinned, ``shared_map`` of a
   ``TaskGraph``, ``refine_mapping=True``, ``global_multisection``,
   ``kaffpa_map_style`` and ``greedy_baseline`` give the card's ``pe_of``
   equal to the CPU's, dtype included. At the main path's size under the
   default config: ``refine_mapping`` (J not above SharedMap's; the host
   seconds of ``quotient_matrix`` and ``swap_refine`` at k = 192), GM,
   ``random_mapping``, ``greedy_baseline``, and ``kaffpa_map_style`` on
   4:8:4 (k = 128) beside SharedMap there; GM and KaFFPa-map must launch
   all five mapping kernels. One line per algorithm: wall seconds, J, and
   J over SharedMap's.
8. The mapping service (``repro_torch.serve.mapper``) on the card. (a) The
   JAX package's own service traffic (``benchmarks/run.py:bench_serve``,
   full size): 24 distinct ``gen_rgg(64)`` graphs on 2:2:2:2 / 1:5:10:100,
   ``preset="fast"``, through the sequential direct path, then as
   ``submit_many`` bursts on a service without a cache, with
   ``pad_batch_pow2`` on and off; every ``pe_of`` equals the direct path's
   and the bursts coalesce (groups > dispatches). The cold first request,
   both walls and the cached-repeat latency are printed. (b) The main
   path's size through the installed service: ``shared_map`` of phase 6's
   graph with a service whose store is a temporary directory gives phase
   6's first ``pe_of`` and J 1,698,496 and launches the five mapping
   kernels; a repeat is a cache hit, and a second service on the same store
   serves it as a store hit. The seconds of the host fetch and the hash of
   the fingerprint are printed. (c) Two ``gen_rgg(2**14)`` requests on
   4:8:6 submitted together against two direct calls one after another.
   (d) Worker mode, on 4:8 (cut from 4:8:6): two worker processes on the
   card answer (c)'s two graphs (``backend`` ``ell``, the direct
   ``pe_of``), then a worker killed on its first dispatch
   (``FaultInjector``, ``worker_kill``) is restarted and its request still
   resolves bit for bit. (e) Shadow verification of one
   ``strategy="device"`` request at 2^14 on 4:8: sampled 1, matched 1, the
   device strategy not quarantined.
9. HLO ingestion and the closed loop (the JAX package's
   ``benchmarks/run.py:bench_model_graphs`` at its size). (a) The committed
   HLO texts of whisper-tiny and xlstm-125m (``tests/data/hlo/``, written
   where JAX runs; the card never compiles HLO) are extracted
   (``launch.comm_graph.extract_comm_graph``, ``min_tasks`` 512): the
   fingerprint, n, m and granularity equal the sidecar's. Each graph is
   mapped on ``physical_hierarchy()`` (16:16, D 1:10, k = 256), ``fast``,
   under ``ell`` (all five mapping kernels launch) and ``xla`` pinned: the
   card's ``pe_of`` equals the CPU's, under ``xla`` also the JAX package's
   (the sidecar's digest, J within ``mapcost``'s rtol), and J is below the
   default placement's. ``sharedmap_device_order(False)`` gives J not above
   the default order's. (b) The segment coarsening path
   (``partition_host(coarsen="segment")``, k = 4, ``fast``, salt 1): on grid
   32x32 and rgg 2000 under ``ell`` and ``xla``, unit and float weights, two
   card runs equal the CPU's; then ``gen_grid(317)`` and
   ``gen_rgg(100_000, seed=1)`` with both ``coarsen`` modes (seconds, cut,
   largest block over Lmax; the segment path launches no coarsening
   kernel). (c) ``coarsen_cascade`` on phase 6's graph with phase 6's ELL
   cap: one synchronizing fetch, only ``hem_propose`` and
   ``contract_edges`` launch, and its per-level sizes equal the v-cycle's
   fine graphs (``partition._coarsen_levels``); the ``gen_grid(1000)``
   10^6 tier (seconds, shrink per level); ``coarsen_telemetry`` through
   ``shared_map`` on grid 32x32: the card's ``stats["coarsen"]`` equals the
   CPU's. (d) The port's own train cells: ``launch.comm_graph.
   compile_model_cell`` (``torch.export`` of the loss on the host) of
   whisper-tiny at seq 64 x batch 4 (the HLO fixture's cell: the FLOP totals
   agree within 0.5%) and xlstm-125m at seq 16 x batch 4 (cut from 64 for the
   export's host time), extracted at ``min_tasks`` 512 and mapped on 16:16,
   ``fast``, under ``ell`` and ``xla`` pinned: the card's ``pe_of`` equals
   the CPU's, and xlstm-125m's J is below the default placement's.
10. The serving path: the llama3.2 smoke config's prefill on the card
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
11. The rest of the model zoo. (a) The smoke configs of moonshot, mixtral,
    jamba, xlstm, whisper and internvl2 on the card against the CPU:
    ``prefill_fn`` (through flash where the family takes it), 8
    ``decode_fn`` steps and ``loss_fn`` at atol 0.15 rtol 0.1; the MoE
    smoke model on duplicate batch rows, equal row for row and over two
    runs. (b) moonshot-v1-16b-a3b at full width, depth cut to 8 layers:
    ``prefill_fn`` on B = 4 x S = 4096 through flash (8 launches) and
    ``_sdpa``, the ``Engine`` (4 prompts of 32 tokens, 32 greedy steps), its
    last prompt step against a flash prefill, ``loss_fn`` on 1 x 2048, one
    prefill profiled. Two runs that round bf16 apart may route a near-tied
    token to other experts, so the second run of each pair takes the first
    run's expert choices and holds its own against them (``_Routes``): at
    most ROUTE_FLIP_SHARE of either top-k's choices may differ, each a
    near-tie (within ROUTE_GAP), and no tie may be ordered two ways.
    (c) xlstm-125m whole (prefill 4 x 1024 at slstm_chunk 8; an Engine
    run; slstm_chunk 1 and 8 are held equal bit for bit in (a), at the
    smoke config), whisper-tiny whole (the memory K/V of 4 x 1,500 frames;
    an Engine run), mixtral-8x22b at 2 layers (prefill 1 x 8192, sliding
    window 4096) and jamba-v0.1-52b at one super-block (prefill 1 x 4096)
    at full width. The flash kernel is held against its plain version on
    layer 0's q/k/v of the moonshot, mixtral and jamba prefills.
12. Training. (a) The six family smoke configs, card against CPU from one
    seeded init: ``loss_fn`` and every gradient in f32 (the compute dtype
    set to float32 for the check), the loss in bf16. (b) On the llama3.2
    smoke config, six AdamW steps straight equal three, a checkpoint, a
    restore into another init and three more, bit for bit. (c) ``python -m
    repro_torch.launch.train --smoke --steps 40 --fail-at 15
    --checkpoint-every 5``: one restart, a final loss below the first.
    (d) llama3.2-3b at full width (28 layers), B 1 x S 2048, three AdamW
    steps under remat ``full`` and ``dots``, and ``none`` at 14 layers
    beside ``full`` at 14 (every activation of 28 layers would not fit
    beside the 58 GB of params, grads and moments): s/step, tok/s, peak
    memory; step 1's loss equals ``loss_fn`` under ``no_grad``; one more
    ``full`` step profiled (device busy share, top ops).
14. The multi-device ``launch/`` pieces (run after phase 12, before the
    kernels line). (a) Two worker processes started after the build (CUDA
    hidden) record the dry-run of llama3.2-3b x train_4k and decode_32k,
    xlstm-125m x train_4k (its sLSTM time scans as loop regions),
    moonshot-v1-16b-a3b x decode_32k, qwen2-72b x prefill_32k and
    jamba-v0.1-52b x prefill_32k on the pod1 mesh, and whisper-tiny x
    train_4k on pod2 (``launch.dryrun``: meta DTensors on a fake world of
    256 or 512 ranks, one rank's step recorded; a worker a mesh, as the
    process group is process-global): host seconds, argument/output bytes
    (held equal to the reference's fixture where ``tests/data/dryrun`` has
    one), FLOPs per device (over the fixture's, held within 2% of the ratio
    ``flops_ratio.json`` gives; ``useful_ratio`` at most 1), ``while_trips``
    and each cell's five largest products, collectives per device. (b)
    llama's and xlstm's per-rank graphs (xlstm's tasks and edges weighted
    by their loop regions' trips) mapped on 16:16, fast, under ell and xla
    on the card (the five mapping kernels launch), ``pe_of`` equal to the
    worker's CPU runs, J against the default placement. (c) One MoE
    layer of moonshot (64 experts, top-6) and of mixtral-8x22b (8 experts,
    so each split into two d_ff shards) at full width: its 16 virtual
    shards run one after another and summed in shard order against V = 1,
    f32 and bf16. (d) A one-rank NCCL world and its ("data", "model")
    mesh: llama3.2's smoke prefill through flash on each rank's share (flash
    launches) and one f32 train step under the mesh ctx, against
    ctx=None. (e) One layer of llama3.2-3b's prefill attention at full
    width (4 x 4096, bf16) split as 16 model ranks split it, by (batch row,
    kv group) units: each rank's ``attention._rank_share`` through flash,
    the ranks in lock-step (``attention.ranks_in_turn``), bit for bit the
    whole call. Prints "phase 14: N s".
13. Prints one JSON line with every kernel's numbers (flash's launches and
    max abs error by path), then the contract's last line. Any failed check raises, and the
    script exits non-zero.

It needs a CUDA device and the repository's ``src/``; without either it
exits with code 2 and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 on the tensor cores, dense

RGG_N = 2**20
# the device strategy keeps every lane at the root's shape; cut from 2^16 for
# the smoke's time limit
RGG_N_STRATEGIES = 2**15
# phase 4's strategies but the device pair, and phase 8 (d)-(e), cut from
# 4:8:6 for the smoke's time limit: their time follows their partition calls
# (9 on 4:8, 55 on 4:8:6)
STRATEGY_HIERARCHY = ("4:8", "1:10")
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


def _launch_key(name: str, args) -> tuple[int, int]:
    """A launch's (lanes, padded size): ``(B, N)`` of the ELL kernels'
    ``[B, N, ...]`` inputs (``(1, N)`` for a graph alone), the shape of
    ``gather_rows``' index (children, padded N or M), ``(1, M)`` for
    ``mapcost``."""
    a = args[0]
    if name == "gather_rows":
        return tuple(args[1].shape)
    if name == "mapcost" or a.dim() == 2:
        return (1, int(a.shape[0]))
    return (int(a.shape[0]), int(a.shape[1]))


def _key_str(key) -> str:
    return f"{key[0]}x{key[1]}"


def _timed_main_path(run, kops):
    """Run ``run()`` with a CUDA event pair around every launch of the
    mapping kernels (the routes in ``kops``), each behind a spin so that the
    pair reads the card's time for the launch (see PAD_CYCLES). Returns
    ``(out, times, captures)``: ``times[kernel][key]`` lists each launch's
    ms by its (lanes, padded size) key (:func:`_launch_key`), and
    ``captures[kernel][key]`` the arguments of the first ``contract_edges``
    call at that key (that of the first partition call there), of the last
    ``lp_gain`` call (the last partition call's; its labels cloned), of the
    first three ``hem_propose`` calls (the three matching rounds of the
    first coarsening level there), and of the last ``mapcost`` call (the J
    of the final mapping)."""
    import torch
    marks, caps = [], {"contract_edges": {}, "lp_gain": {}, "hem_propose": {}, "mapcost": {}}
    saved = {name: getattr(kops, name) for name in MAPPING_KERNELS}

    def hook(name, orig):
        def timed(*args):
            n = _launch_key(name, args)
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
    bytes, operations, library)``; ``cand`` [B, N, D2] (or [N, D2]), the
    B * N rows of one launch. Bytes: each input read once, each output
    written once. Operations: what this data needs, one compare-add for
    each pair of live slots of a row."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    cand, candw = args
    N, D2 = cand.shape[-2:]
    T = cand.numel() // D2
    live = (cand != N).sum(-1, dtype=torch.int64)
    return (f"{_key_str(_launch_key('contract_edges', args))} x {D2}, "
            f"{int(live.sum())} live slots",
            lambda a, b: kops.contract_edges_cuda(a, b, N),
            lambda a, b: ref.contract_edges_ref(a, b, N), (cand, candw),
            16 * T * D2 + 4 * T, int((live * live).sum()), None)


def _lp_gain_case(args):
    """A captured ``lp_gain`` call, as :func:`_contract_case`: ``adj``
    [B, N, DEG], ``parts`` [B, R, N] (or without the lane axis). Operations:
    one add per live slot and restart. Library: ``scatter_add_`` of conn."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    adj, adw, parts, k = args
    lanes = adj if adj.dim() == 3 else adj[None]
    B, N, DEG = lanes.shape
    R = parts.shape[-2]
    labels = parts.reshape(B, R, N)
    ids = lanes.clamp(0, N - 1).long().reshape(B, 1, -1).expand(B, R, N * DEG)
    nbr = torch.where(lanes[:, None] < N, labels.gather(2, ids).view(B, R, N, DEG), 0).long()
    nbr = nbr.view(*parts.shape[:-1], N, DEG)
    live = int((adj < N).sum())
    return (f"{_key_str(_launch_key('lp_gain', args))}, DEG={DEG} R={R} k={k}, "
            f"{live} live slots",
            lambda a, w, p: kops.lp_gain_cuda(a, w, p, k),
            lambda a, w, p: ref.lp_gain_ref(a, w, p, k), (adj, adw, parts),
            8 * B * N * DEG + 4 * B * R * N + B * R * N * (4 * k + 8), R * live,
            lambda a, w, p: torch.zeros(*nbr.shape[:-1], k, device=a.device).scatter_add_(
                -1, nbr, w.unsqueeze(-3).expand(nbr.shape)))


def _hem_case(args):
    """A captured ``hem_propose`` call, as :func:`_contract_case` (``adj``
    [B, N, DEG] or [N, DEG]). Bytes: the ids, weights and jitters of every
    unmatched row (a matched row proposes N from its flag alone), and every
    row's flag and proposal. Operations: one score (a multiply, an add and
    a fused multiply-add) per valid slot."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    adj, adw, jit, matched = args
    N, DEG = adj.shape[-2:]
    free = matched == 0
    u = torch.arange(N, device=adj.device)[:, None]
    nbr_free = free.gather(-1, adj.clamp(0, N - 1).long().reshape(*free.shape[:-1], -1))
    valid = (free[..., None] & (adj < N) & (adj != u) & nbr_free.view(adj.shape))
    live = int(free.sum())
    return (f"{_key_str(_launch_key('hem_propose', args))} x {DEG}, {live} unmatched rows, "
            f"{int(valid.sum())} valid slots",
            lambda *a: kops.hem_propose_cuda(*a), ref.hem_propose_ref, args,
            12 * DEG * live + 8 * matched.numel(), 4 * int(valid.sum()), None)


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


def _widest_dispatch(args, _build) -> None:
    """Phase 6's widest dispatch (the main path's 48 lanes at 2^15 under
    ``ell``), again on its captured inputs: one ``batched_partition`` call
    profiled (device ops, busy share, launches), one unprofiled with its
    peak memory, then its lanes one at a time (B = 1 calls, as the lanes
    ran before they were batched). All three must give the same labels."""
    import torch
    from repro_torch.core.graph import Graph
    from repro_torch.core.partition import (Preset, batched_partition, lane_bytes,
                                            lanes_per_chunk)
    gs, k, eps, salts, levels, preset, backend, deg = args
    B = len(salts)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        whole = batched_partition(*args)
        torch.cuda.synchronize()
    t_prof = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    ops = sum(e.count for e in events)
    del prof
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    again = batched_partition(*args)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    alone = torch.cat([batched_partition(Graph(*(a[i:i + 1] for a in gs)), k, eps[i:i + 1],
                                         salts[i:i + 1], levels, preset, backend, deg)
                       for i in range(B)])
    torch.cuda.synchronize()
    t_alone = time.perf_counter() - t0
    if not (torch.equal(whole, again) and torch.equal(whole, alone)):
        raise AssertionError("the widest dispatch: the batched call and its lanes one at a "
                             "time give other labels")
    chunk = lanes_per_chunk(lane_bytes(gs.N, gs.M, k, levels, Preset.get(preset).restarts,
                                       deg))
    print(f"widest dispatch: {B} lanes at N={gs.N} M={gs.M}, k={k}, {levels} levels, "
          f"{preset}, {backend}, cap {deg}, {chunk} lanes a chunk: batched {t_batch:.2f} s (peak {peak / 1e9:.2f} GB above the "
          f"{base / 1e9:.2f} GB held), under the profiler {t_prof:.2f} s with {ops} device ops, "
          f"device busy {busy:.3f} s, launches {launches}; the lanes one at a time "
          f"{t_alone:.2f} s ({t_alone / t_batch:.1f}x); equal labels", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"widest dispatch profile:   {e.self_device_time_total / 1e3:10.2f} ms  "
              f"{e.count:7d}x  {e.key[:90]}", flush=True)


def _flash_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the causal / window mask keeps in one [S, S]
    slice: the work attention needs, whatever the kernel's tiling."""
    pairs = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += hi - lo
    return pairs


class _FirstFlash:
    """While active, keeps the arguments of the first flash launch, q/k/v
    cloned as the model hands them over: ``args`` = (q, k, v, causal,
    window)."""

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        self.kops, self.orig, self.args = kops, kops.flash_attention_cuda, None

        def first_call(q, k, v, causal, window):
            if self.args is None:
                self.args = (q.clone(), k.clone(), v.clone(), causal, window)
            return self.orig(q, k, v, causal, window)
        kops.flash_attention_cuda = first_call
        return self

    def __exit__(self, *exc):
        self.kops.flash_attention_cuda = self.orig


def _flash_held(label, args) -> float:
    """Hold the flash kernel against its plain version (``flash_bshd_ref``)
    on captured ``args`` at FLASH_TOL; the plain version runs one KV head's
    query heads at a time, so its f32 [S, S] scores fit at S 8192. Returns
    the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flashattn import flash_attention_cuda
    q, k, v, causal, window = args
    got = flash_attention_cuda(q, k, v, causal, window)
    rtol, atol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    rep = q.shape[2] // k.shape[2]
    err, share = 0.0, 0.0
    for g in range(k.shape[2]):
        hs = slice(g * rep, (g + 1) * rep)
        want = ref.flash_bshd_ref(q[:, :, hs], k[:, :, g:g + 1], v[:, :, g:g + 1], causal,
                                  window).float()
        d = (got[:, :, hs].float() - want).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / (atol + rtol * want.abs())).max()))
    print(f"flash_attention at the {label}'s layer-0 q/k/v: q {list(q.shape)} k/v "
          f"{list(k.shape)} {q.dtype} causal={causal} window={window}: max abs err {err:.3g}, "
          f"worst {share:.3f} of the allowed error (rtol {rtol:.4g} atol {atol})", flush=True)
    if share > 1:
        raise AssertionError(f"flash_attention disagrees with its plain version at the "
                             f"{label}'s layer 0")
    return err


def _serving_path(dev, check, _build) -> int:
    """Phase 10: llama3.2-3b prefill (flash and _sdpa), the Engine, a profile
    and the flash kernel against its plain version. Returns the flash
    launches of one full-width prefill."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, get_smoke_config
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

    def prefill(ctx):
        torch.cuda.reset_peak_memory_stats()
        out = MM.prefill_fn(cfg, params, {"tokens": tokens}, ctx)
        return out, torch.cuda.max_memory_allocated()
    with _FirstFlash() as first:   # layer 0's q/k/v, kept as handed over
        (lf, peak_f), t_f, ln_f = _run_path("prefill, flash", lambda: prefill(flash),
                                            ["flash_attention"], _build)
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
    q, k, v, causal, window = first.args
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


# ---- phase 11: the rest of the model zoo ---------------------------------------

ZOO = ("moonshot-v1-16b-a3b", "mixtral-8x22b", "jamba-v0.1-52b", "xlstm-125m",
       "whisper-tiny", "internvl2-76b")
ZOO_FLASH = {"moonshot-v1-16b-a3b", "mixtral-8x22b", "jamba-v0.1-52b", "internvl2-76b"}
ZOO_STEPS = 8                       # decode steps of (a)
MOE_ARCH, MOE_LAYERS = "moonshot-v1-16b-a3b", 8            # depth cut from 48
MOE_ENGINE_B, MOE_ENGINE_P, MOE_ENGINE_STEPS, MOE_ENGINE_MAX_LEN = 4, 32, 32, 128
MOE_LOSS_B, MOE_LOSS_S = 1, 2048
XLSTM_B, XLSTM_S, XLSTM_CHUNKS = 4, 1024, (1, 8)
WHISPER_B, WHISPER_T = 4, 1500
ZOO_ENGINE_B, ZOO_ENGINE_P, ZOO_ENGINE_STEPS = 4, 16, 16   # xlstm and whisper engines
MIXTRAL_LAYERS, MIXTRAL_S = 2, 8192                        # depth cut from 56
JAMBA_LAYERS, JAMBA_S = 8, 4096                            # one super-block (of 4)


# Two runs of one MoE model that round bf16 in other places route a token
# apart only at a near-tie. Held in ``_Routes``: at most this share of either
# top-k's choices may differ, and each run may rank the choices only it made
# above those only the other made by at most ROUTE_GAP, in log units of the
# values the top-k ranks (router: log-probabilities, i.e. logit differences;
# capacity: log-gates). Set from the readings on an H100 (PERF.md): the most
# is flash against _sdpa at full width, 0.89% of the router's choices at most
# 0.0703 apart (one bf16 ulp of a logit in [2, 4) is 0.0156), 0.22% of the
# capacity cut's at most 0.0569.
ROUTE_FLIP_SHARE = 0.02
ROUTE_GAP = 0.125


class _Routes:
    """The MoE's discrete choices of one run, replayed in another.

    ``moe.moe_ffn_shard`` makes two top-k choices per call, in this order:
    each token's top-k experts (the router) and each expert's top-C tokens
    (the capacity cut). Two runs of one MoE model that round bf16 in other
    places (the card and the CPU; flash and ``_sdpa``; a prefill and the
    Engine's decode steps) may break a near-tie in either the other way
    (ROADMAP Queue 3): with 64 experts top-6 the router's bf16 logits tie
    often, and one flip moves logits by more than the tolerance. To hold
    the rest of the two computations against each other, the second run
    takes the first run's choices (the values at them from its own
    inputs), and holds the choices its own top-k would have changed (flips:
    (token, expert) pairs for the router, (expert, token) pairs for the
    capacity cut). Each flip must be a near-tie in both runs' values: in a
    row where the two top-k sets differ, each run ranks the choices only it
    made above those only the other made, by at most ROUTE_GAP (log units).
    A row whose differing choices tie exactly in both runs is a tie ordered
    two ways (both sides put the lower index first, so that never happens)
    and fails. ``held`` fails if either site
    flipped more than ROUTE_FLIP_SHARE of its choices."""

    def __init__(self, moe):
        self.moe, self.orig = moe, moe.top_k
        self.calls = []
        self._reset()

    def _reset(self):
        self.flips, self.total, self.gap = [0, 0], [0, 0], [0.0, 0.0]

    def record(self):
        def rec(x, k):
            out = self.orig(x, k)
            self.calls.append((x.detach().clone(), out[1]))
            return out
        self.calls = []
        self.moe.top_k = rec
        return self

    def replay(self, router=None):
        """Call i takes the i-th recorded call's (values, indices); with
        ``router``, the router's l-th call (call 2l) takes ``router(l)``
        and the capacity cuts run as they are."""
        count = [0]

        def rep(x, k):
            i, count[0] = count[0], count[0] + 1
            own_v, own = self.orig(x, k)
            if router is not None:
                if i % 2:
                    return own_v, own
                x0, idx = router(i // 2)
            else:
                x0, idx = self.calls[i]
            x0, idx = x0.to(x.device), idx.to(x.device)
            if idx.shape != own.shape or x0.shape != x.shape:
                raise AssertionError(f"routes: call {i} has {tuple(own.shape)}, replayed "
                                     f"{tuple(idx.shape)}")
            self._check(i % 2, x, own_v, own, x0, idx)
            return x.gather(-1, idx), idx
        self._reset()
        self.moe.top_k = rep
        return self

    def _check(self, site, x, own_v, own, x0, idx):
        import torch
        dropped = (idx[:, :, None] != own[:, None, :]).all(-1)   # first run's, not own
        n = int(dropped.sum())
        self.flips[site] += n
        self.total[site] += idx.numel()
        if not n:
            return
        rows = dropped.any(-1)
        added = (own[:, :, None] != idx[:, None, :]).all(-1)[rows]   # own, not first run's
        dropped, own, idx = dropped[rows], own[rows], idx[rows]
        xr, x0r = x[rows].float(), x0[rows].float()
        inf = torch.tensor(torch.inf, device=x.device)

        def spread(vals, hi, hi_idx, lo, lo_idx):   # log of the highest of one set
            top = torch.where(hi, vals.gather(-1, hi_idx), -inf).max(-1).values
            low = torch.where(lo, vals.gather(-1, lo_idx), inf).min(-1).values
            return top.log() - low.log()            # over the lowest of the other
        # each run ranks its own choices above the other run's: by how much,
        # in its own values, at most
        gap_own = spread(xr, added, own, dropped, idx)
        gap_first = spread(x0r, dropped, idx, added, own)
        gaps = torch.stack([gap_own, gap_first])
        name = ("router", "capacity")[site]
        if not torch.isfinite(gaps).all() or bool((gaps < 0).any()):
            raise AssertionError(f"routes: a {name} flip off the ranked values: {gaps}")
        ties = int(((gap_own == 0) & (gap_first == 0)).sum())
        if ties:
            raise AssertionError(f"routes: {ties} {name} ties ordered two ways")
        worst = float(gaps.max())
        self.gap[site] = max(self.gap[site], worst)
        if worst > ROUTE_GAP:
            raise AssertionError(f"routes: a {name} flip {worst:.4g} apart (log units; limit "
                                 f"{ROUTE_GAP}): not a near-tie")

    def held(self, what):
        """Raise if either site flipped more than ROUTE_FLIP_SHARE of its
        choices; else describe the flips."""
        for site, name in enumerate(("router", "capacity")):
            if self.flips[site] > ROUTE_FLIP_SHARE * self.total[site]:
                raise AssertionError(f"{what}: {self.flips[site]} of {self.total[site]} {name} "
                                     f"choices differ (limit {ROUTE_FLIP_SHARE})")
        return (f"{self.flips[0]} of {self.total[0]} router (token, expert) and {self.flips[1]} "
                f"of {self.total[1]} capacity (expert, token) choices, at most "
                f"{self.gap[0]:.4g} and {self.gap[1]:.4g} apart (limits: share "
                f"{ROUTE_FLIP_SHARE}, gap {ROUTE_GAP})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.moe.top_k = self.orig


def _zoo_batch(cfg, B, S, seed, dev):
    """Tokens, labels and the stub frontends' inputs, from a seed (frames of
    S positions with 16 target tokens; num_patches patches before S text
    tokens)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, S))),
         "labels": torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, S)))}
    if cfg.frontend == "vision_stub":
        b["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.02).to(torch.bfloat16)
    if cfg.is_encoder_decoder:
        b["frames"] = torch.as_tensor(
            rng.standard_normal((B, S, cfg.d_model)) * 0.02).to(torch.bfloat16)
        b["tokens"], b["labels"] = b["tokens"][:, :16], b["labels"][:, :16]
    return {k: v.to(dev) for k, v in b.items()}


def _held(what, got, want, atol=LOGITS_ATOL, rtol=LOGITS_RTOL):
    """Raise unless ``got`` (card) and ``want`` agree; print the difference."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    diff = 0.0
    for a, b in zip(got, want):
        a, b = a.float().cpu(), b.float().cpu()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what}: shape {tuple(a.shape)} against {tuple(b.shape)}, "
                                 "or not finite")
        diff = max(diff, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=atol, rtol=rtol):
            over = (a - b).abs() > atol + rtol * b.abs()
            worst = int(((a - b).abs() - atol - rtol * b.abs()).argmax())
            raise AssertionError(
                f"{what}: max abs diff {diff:.4g} (atol {atol} rtol {rtol}); "
                f"{int(over.sum())} of {a.numel()} values outside, the worst "
                f"{float(a.flatten()[worst]):.4g} against {float(b.flatten()[worst]):.4g}")
    return diff


def _zoo_small(dev, _build, moe) -> None:
    """Phase 11 (a): each new family's smoke config on the card against the
    CPU (prefill_fn, 8 decode_fn steps, loss_fn), and the MoE combine on
    duplicate batch rows."""
    import copy
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as MM
    from repro_torch.models.sharding import ShardCtx
    ctx = ShardCtx(use_flash=True)
    for arch in ZOO:
        cfg = get_smoke_config(arch)
        p_cpu = MM.init_fn(cfg, torch.Generator(device="cpu").manual_seed(0))
        p_dev = copy.deepcopy(p_cpu).to(dev)
        b_cpu = _zoo_batch(cfg, 2, 64, 1, "cpu")
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        routes = _Routes(moe)
        with routes.record():
            want = MM.prefill_fn(cfg, p_cpu, b_cpu, ctx)
            caches = [MM.init_cache(cfg, 2, 16, device=d) for d in ("cpu", dev)]
            if cfg.is_encoder_decoder:   # memory K/V of 16 frames from each side
                fr = _zoo_batch(cfg, 2, 16, 2, "cpu")
                caches[0]["mem_kv"] = MM.prefill_fn(cfg, p_cpu, fr)
            toks = _zoo_batch(cfg, 2, ZOO_STEPS, 3, "cpu")["tokens"]
            want_steps = [MM.decode_fn(cfg, p_cpu, toks[:, i:i + 1], caches[0], i)[0]
                          for i in range(ZOO_STEPS)]
            want_loss = MM.loss_fn(cfg, p_cpu, b_cpu)
        expect = ["flash_attention"] if arch in ZOO_FLASH else []
        with routes.replay():
            got, t_p, ln = _run_path(f"{arch} smoke prefill", lambda: MM.prefill_fn(
                cfg, p_dev, b_dev, ctx), expect, _build)
            if cfg.is_encoder_decoder:
                caches[1]["mem_kv"] = MM.prefill_fn(cfg, p_dev, {k: v.to(dev)
                                                                 for k, v in fr.items()})
            got_steps = [MM.decode_fn(cfg, p_dev, toks[:, i:i + 1].to(dev), caches[1], i)[0]
                         for i in range(ZOO_STEPS)]
            got_loss = MM.loss_fn(cfg, p_dev, b_dev)
        d_p = _held(f"{arch} smoke prefill_fn", got, want)
        d_d = max(_held(f"{arch} smoke decode step {i}", g, w)
                  for i, (g, w) in enumerate(zip(got_steps, want_steps)))
        _held(f"{arch} smoke loss_fn", got_loss, want_loss)
        print(f"{arch} smoke ({cfg.family}): card against CPU, prefill_fn B=2 S=64 max abs "
              f"diff {d_p:.4g} ({t_p:.3f} s, flash launches {ln['flash_attention']}), "
              f"{ZOO_STEPS} decode_fn steps {d_d:.4g}, loss_fn {float(got_loss):.6f} against "
              f"{float(want_loss):.6f}; on the CPU's MoE choices, the card's own would have "
              f"changed {routes.held(arch)}; atol {LOGITS_ATOL} rtol {LOGITS_RTOL}", flush=True)
        if cfg.family == "ssm":   # the sLSTM's time chunk changes no value
            for chunk in XLSTM_CHUNKS[1:]:
                other = MM.prefill_fn(cfg, p_dev, b_dev, ShardCtx(use_flash=True,
                                                                  slstm_chunk=chunk))
                if not torch.equal(other, got):
                    raise AssertionError(f"{arch} smoke: slstm_chunk {chunk} differs from 1")
            print(f"{arch} smoke prefill_fn on the card at slstm_chunk {XLSTM_CHUNKS}: equal "
                  f"bit for bit", flush=True)
    # duplicate batch rows through the MoE smoke model on the card
    cfg = get_smoke_config(MOE_ARCH)
    p = MM.init_fn(cfg, torch.Generator(device=dev).manual_seed(0))
    t = _zoo_batch(cfg, 2, 64, 4, dev)["tokens"]
    rows = {"tokens": torch.cat([t, t])}   # rows 0, 1 again as rows 2, 3
    a, b = (MM.prefill_fn(cfg, p, rows, ctx) for _ in range(2))
    if not (torch.equal(a, b) and torch.equal(a[:2], a[2:])):
        raise AssertionError("MoE smoke prefill: duplicate rows or two runs differ")
    print(f"{cfg.name} prefill_fn on the card, rows [r0, r1, r0, r1]: equal row for row, "
          f"and equal over two runs", flush=True)


def _zoo_moonshot(dev, _build, moe) -> int:
    """Phase 11 (b): moonshot-v1-16b-a3b at full width, 8 layers: prefill
    (flash and _sdpa), the Engine, the loss, a profile. Returns the flash
    launches of one prefill."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as MM
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = MM.init_fn(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params.parameters())
    print(f"{MOE_ARCH}: {cfg.num_layers} layers (cut from 48), d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, {cfg.num_experts} "
          f"experts top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} params "
          f"(f32, {4 * n_params / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    B, S = PREFILL_B, PREFILL_S
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)),
                             device=dev)
    flash, dense = ShardCtx(use_flash=True), ShardCtx()
    MM.prefill_fn(cfg, params, {"tokens": tokens[:, :256]}, flash)   # warm-up

    def prefill(ctx):
        torch.cuda.reset_peak_memory_stats()
        out = MM.prefill_fn(cfg, params, {"tokens": tokens}, ctx)
        return out, torch.cuda.max_memory_allocated()
    from repro_torch.models.moe import capacity
    routes = _Routes(moe)
    with routes.record(), _FirstFlash() as first:
        (lf, peak_f), t_f, ln_f = _run_path(f"{MOE_ARCH} prefill, flash",
                                            lambda: prefill(flash), ["flash_attention"], _build)
    with routes.replay():
        (ld, peak_d), t_d, ln_d = _run_path(f"{MOE_ARCH} prefill, _sdpa",
                                            lambda: prefill(dense), [], _build)
    if ln_f["flash_attention"] != cfg.num_layers or ln_d["flash_attention"] != 0:
        raise AssertionError(f"flash launches {ln_f['flash_attention']} (flash) and "
                             f"{ln_d['flash_attention']} (_sdpa), expected {cfg.num_layers}, 0")
    for label, t, pk in (("flash", t_f, peak_f), ("_sdpa", t_d, peak_d)):
        print(f"prefill_fn {MOE_ARCH} B={B} S={S} (T {B * S}, capacity C "
              f"{capacity(cfg, B * S)} per expert), {label}: {t:.3f} s, {B * S / t:.0f} "
              f"tokens/s, peak memory {pk} B", flush=True)
    d = _held(f"{MOE_ARCH} prefill logits, flash against _sdpa", lf, ld)
    print(f"prefill logits {MOE_ARCH}, flash against _sdpa (the _sdpa run on the flash run's "
          f"MoE choices): max abs diff {d:.4g}, argmax agreement "
          f"{float((lf.argmax(-1) == ld.argmax(-1)).float().mean()):.2f}; _sdpa's own would "
          f"have changed {routes.held(f'{MOE_ARCH} prefill, _sdpa')}; flash launches "
          f"{ln_f['flash_attention']}; atol {LOGITS_ATOL} rtol {LOGITS_RTOL}", flush=True)
    del lf, ld
    torch.cuda.empty_cache()
    flash_err = _flash_held(f"{MOE_ARCH} prefill", first.args)

    # the Engine; its last prompt step held against a flash prefill of the
    # prompts that drops no token by capacity (the Engine's steps, T = B = 4
    # tokens, drop none) on the Engine's expert choices
    Bp, P = MOE_ENGINE_B, MOE_ENGINE_P
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (Bp, P))
    eng = Engine(cfg, params, max_len=MOE_ENGINE_MAX_LEN)
    prompt_logits = []
    orig_decode = MM.decode_fn

    def keep_last_prompt_step(cfg_, p, t, cache, pos, ctx=None):
        out = orig_decode(cfg_, p, t, cache, pos, ctx)
        if pos == P - 1:
            prompt_logits.append(out[0].clone())
        return out
    MM.decode_fn = keep_last_prompt_step
    try:
        with routes.record():
            (gen_toks, stats), t_e, _ = _run_path(
                f"{MOE_ARCH} engine", lambda: eng.generate(prompts, MOE_ENGINE_STEPS), [],
                _build)
    finally:
        MM.decode_fn = orig_decode
    if gen_toks.shape != (Bp, MOE_ENGINE_STEPS) or not (
            (gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all():
        raise AssertionError(f"engine tokens: shape {gen_toks.shape} or out of range")
    print(f"engine {MOE_ARCH} B={Bp} prompt {P} steps {MOE_ENGINE_STEPS} max_len "
          f"{MOE_ENGINE_MAX_LEN}: prompt (stepped) {stats.prefill_s:.3f} s, decode "
          f"{stats.decode_s:.3f} s, {stats.tok_per_s:.1f} tok/s, {t_e:.3f} s in all; first "
          f"tokens {gen_toks[:, :6].tolist()}", flush=True)
    del eng
    torch.cuda.empty_cache()
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    L = cfg.num_layers
    steps = routes.calls[::2]   # router (probabilities [B, E], choices [B, K]) per
    #                             (prompt position, layer), ...

    def by_position(layer):     # the prefill's tokens are b-major: row b * P + s
        return tuple(torch.stack([steps[s * L + layer][j] for s in range(P)], dim=1).reshape(
            Bp * P, -1) for j in (0, 1))
    with routes.replay(by_position):
        pf = MM.prefill_fn(nodrop, params, {"tokens": torch.as_tensor(prompts, device=dev)},
                           flash)
    d = _held(f"{MOE_ARCH} flash prefill against the engine's last prompt step", pf,
              prompt_logits[0])
    print(f"flash prefill_fn {MOE_ARCH} ({Bp} x {P} tokens, capacity factor "
          f"{nodrop.capacity_factor:.4g}: C = T, nothing dropped) against the engine's last "
          f"prompt step, on the engine's expert choices: max abs diff {d:.4g}, argmax "
          f"agreement {float((pf.argmax(-1) == prompt_logits[0].argmax(-1)).float().mean()):.2f}"
          f"; the prefill's own would have changed "
          f"{routes.held(f'{MOE_ARCH} prefill on the engine choices')}; atol {LOGITS_ATOL} "
          f"rtol {LOGITS_RTOL}", flush=True)

    # the loss, then one flash prefill profiled
    b = _zoo_batch(cfg, MOE_LOSS_B, MOE_LOSS_S, 5, dev)
    loss, t_l, _ = _run_path(f"{MOE_ARCH} loss_fn", lambda: MM.loss_fn(cfg, params, b), [],
                             _build)
    if not torch.isfinite(loss):
        raise AssertionError(f"{MOE_ARCH} loss_fn: {float(loss)}")
    print(f"loss_fn {MOE_ARCH} B={MOE_LOSS_B} S={MOE_LOSS_S}: {float(loss):.6f} (ln V = "
          f"{np.log(cfg.vocab_size):.4f}), {t_l:.3f} s", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        MM.prefill_fn(cfg, params, {"tokens": tokens}, flash)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profile: prefill_fn {MOE_ARCH} flash B={B} S={S}: wall {wall:.3f} s under the "
          f"profiler, device busy {busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{sum(e.count for e in events)} device ops", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile:   {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
              f"{e.key[:90]}", flush=True)
    del prof, events, params, tokens
    torch.cuda.empty_cache()
    return ln_f["flash_attention"], flash_err


def _zoo_others(dev, _build) -> dict:
    """Phase 11 (c): xlstm-125m and whisper-tiny whole, mixtral-8x22b (2
    layers) and jamba-v0.1-52b (one super-block) at full width. Returns the
    flash launches of each prefill and the kernel's max abs error against
    its plain version at the prefill's layer 0."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as MM
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.serve.engine import Engine
    launches, errs = {}, {}

    def engine(arch, cfg, params):
        prompts = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                    (ZOO_ENGINE_B, ZOO_ENGINE_P))
        (toks, st), t, _ = _run_path(f"{arch} engine", lambda: Engine(
            cfg, params, max_len=ZOO_ENGINE_P + ZOO_ENGINE_STEPS).generate(
                prompts, ZOO_ENGINE_STEPS), [], _build)
        if toks.shape != (ZOO_ENGINE_B, ZOO_ENGINE_STEPS) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{arch} engine tokens: shape {toks.shape} or out of range")
        print(f"engine {arch} B={ZOO_ENGINE_B} prompt {ZOO_ENGINE_P} steps {ZOO_ENGINE_STEPS}: "
              f"prompt (stepped) {st.prefill_s:.3f} s, decode {st.decode_s:.3f} s, "
              f"{st.tok_per_s:.1f} tok/s, {t:.3f} s in all", flush=True)

    def drawn(arch, cfg, cut):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = MM.init_fn(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n = sum(w.numel() for w in params.parameters())
        print(f"{arch}: {cfg.num_layers} layers{cut}, d_model {cfg.d_model}; {n} params (f32, "
              f"{4 * n / 1e9:.2f} GB) drawn on the card in {time.perf_counter() - t0:.2f} s",
              flush=True)
        return params

    # xlstm-125m whole: the sLSTM time scan (one step per position whatever
    # the chunk; (a) holds chunks 1 and 8 equal)
    cfg = get_config("xlstm-125m")
    params = drawn("xlstm-125m", cfg, "")
    b = _zoo_batch(cfg, XLSTM_B, XLSTM_S, 6, dev)
    chunk = XLSTM_CHUNKS[-1]
    out, t, _ = _run_path(f"xlstm-125m prefill, slstm_chunk {chunk}", lambda: MM.prefill_fn(
        cfg, params, b, ShardCtx(slstm_chunk=chunk)), [], _build)
    if out.shape != (XLSTM_B, 1, cfg.vocab_size) or not torch.isfinite(out.float()).all():
        raise AssertionError(f"xlstm-125m prefill logits: shape {tuple(out.shape)} or not finite")
    print(f"prefill_fn xlstm-125m B={XLSTM_B} S={XLSTM_S} slstm_chunk {chunk}: {t:.3f} s, "
          f"{XLSTM_B * XLSTM_S / t:.0f} tokens/s", flush=True)
    engine("xlstm-125m", cfg, params)
    del params, out
    torch.cuda.empty_cache()

    # whisper-tiny whole: the decoder's memory K/V of 1,500 frames
    cfg = get_config("whisper-tiny")
    params = drawn("whisper-tiny", cfg, "")
    frames = _zoo_batch(cfg, WHISPER_B, WHISPER_T, 7, dev)
    (mk, mv), t, _ = _run_path("whisper-tiny prefill_memory", lambda: MM.prefill_fn(
        cfg, params, frames), [], _build)
    want = (cfg.num_layers, WHISPER_B, WHISPER_T, cfg.num_kv_heads, cfg.head_dim)
    if mk.shape != want or mv.shape != want or not (
            torch.isfinite(mk.float()).all() and torch.isfinite(mv.float()).all()):
        raise AssertionError(f"whisper-tiny memory K/V: {tuple(mk.shape)} or not finite")
    print(f"prefill_fn whisper-tiny B={WHISPER_B} frames {WHISPER_T}: memory K/V "
          f"{list(mk.shape)} x 2 in {t:.3f} s, {WHISPER_B * WHISPER_T / t:.0f} frames/s",
          flush=True)
    engine("whisper-tiny", cfg, params)
    del params, mk, mv
    torch.cuda.empty_cache()

    # mixtral-8x22b and jamba-v0.1-52b at full width, depth cut: prefill only
    for arch, layers, S in (("mixtral-8x22b", MIXTRAL_LAYERS, MIXTRAL_S),
                            ("jamba-v0.1-52b", JAMBA_LAYERS, JAMBA_S)):
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        params = drawn(arch, cfg, f" (cut from {full.num_layers})")
        tokens = {"tokens": torch.as_tensor(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (1, S)), device=dev)}

        def prefill():
            torch.cuda.reset_peak_memory_stats()
            out = MM.prefill_fn(cfg, params, tokens, ShardCtx(use_flash=True))
            return out, torch.cuda.max_memory_allocated()
        with _FirstFlash() as first:
            (out, peak), t, ln = _run_path(f"{arch} prefill, flash", prefill,
                                           ["flash_attention"], _build)
        kinds = cfg.layer_kinds()   # one attention sub-layer per super-block
        n_attn = sum(k.startswith("attn") for k in kinds) * (layers // len(kinds))
        if ln["flash_attention"] != n_attn or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{arch}: flash launches {ln['flash_attention']} (expected "
                                 f"{n_attn}) or logits not finite")
        launches[f"{arch} prefill"] = ln["flash_attention"]
        print(f"prefill_fn {arch} B=1 S={S} flash (window {cfg.sliding_window}): {t:.3f} s, "
              f"{S / t:.0f} tokens/s, peak memory {peak} B, flash launches "
              f"{ln['flash_attention']}", flush=True)
        del params, out
        torch.cuda.empty_cache()
        errs[f"{arch} prefill"] = _flash_held(f"{arch} prefill", first.args)
    return launches, errs


def _zoo_path(dev, _build) -> tuple[dict, dict]:
    """Phase 11: the rest of the model zoo. Returns the flash launches of
    each full-width prefill, and the kernel's max abs error at its layer 0."""
    from repro_torch.models import moe
    t0 = time.perf_counter()
    _zoo_small(dev, _build, moe)
    t_a = time.perf_counter() - t0
    ln, err = _zoo_moonshot(dev, _build, moe)
    launches, errs = {f"{MOE_ARCH} prefill": ln}, {f"{MOE_ARCH} prefill": err}
    t_b = time.perf_counter() - t0 - t_a
    ln, err = _zoo_others(dev, _build)
    launches.update(ln)
    errs.update(err)
    total = time.perf_counter() - t0
    print(f"phase 11: {total:.1f} s in all ((a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) "
          f"{total - t_a - t_b:.1f} s)", flush=True)
    return launches, errs


def _service_path(dev, g, h, pe_main, j_main, _build) -> None:
    """Phase 8: the mapping service on the card (see the module doc)."""
    import concurrent.futures
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core.api import SharedMapConfig, shared_map, shared_map_direct
    from repro_torch.core.hierarchy import parse_hierarchy
    from repro_torch.faults import FaultInjector
    from repro_torch.serve import mapper as SM

    def same(a, b, what):
        if not (np.array_equal(a.pe_of, b.pe_of) and a.J == b.J):
            raise AssertionError(f"service {what}: pe_of or J differs from the direct path's")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def coalesced(before, after):
        co = {k: after[k] - before[k] for k in after}
        if not co["groups"] > co["dispatches"]:
            raise AssertionError(f"service burst did not coalesce: {co}")
        return co

    # (a) the JAX package's service traffic (benchmarks/run.py:bench_serve)
    hs = parse_hierarchy(*SERVE_H)
    cfg = SharedMapConfig(preset="fast", seed=1)
    gs = [G.gen_rgg(SERVE_N, seed=100 + i, device=dev) for i in range(SERVE_R)]
    shared_map_direct(gs[0], hs, cfg, device=dev)   # the allocator's first blocks
    direct, t_seq = timed(lambda: [shared_map_direct(x, hs, cfg, device=dev) for x in gs])
    for pad in (True, False):
        svc = SM.MappingService(cache_entries=0, pad_batch_pow2=pad, device=dev)
        try:
            first, t_cold = timed(lambda: svc.map(gs[0], hs, cfg))
            same(first, direct[0], "(a) first request")
            co0 = svc.stats()["coalesce"]
            out, t_burst = timed(lambda: [f.result() for f in svc.submit_many(
                [(x, hs, cfg) for x in gs])])
            co = coalesced(co0, svc.stats()["coalesce"])
        finally:
            svc.close()
        for i, (a, b) in enumerate(zip(out, direct)):
            same(a, b, f"(a) burst request {i}, pad_batch_pow2={pad}")
        print(f"service (a) {SERVE_R} x rgg {SERVE_N} on {hs}, fast, pad_batch_pow2={pad}: "
              f"first request {t_cold:.3f} s, burst {t_burst:.3f} s against the "
              f"sequential direct path's {t_seq:.3f} s (ratio {t_burst / t_seq:.3f}); "
              f"burst coalesce {co}; every pe_of equal to the direct path's", flush=True)
    svc = SM.MappingService(device=dev)
    try:
        svc.map(gs[0], hs, cfg)
        reps = 20
        hits, t_hits = timed(lambda: [svc.map(gs[0], hs, cfg) for _ in range(reps)])
    finally:
        svc.close()
    if not all(r.stats["result_cache"]["hit"] for r in hits):
        raise AssertionError("service (a): a repeat was not a cache hit")
    print(f"service (a) cached repeat rgg {SERVE_N}: {t_hits / reps * 1e3:.3f} ms a request "
          f"({t_seq / SERVE_R / (t_hits / reps):.0f}x below a direct request)", flush=True)
    del gs, direct, out, hits

    # (b) the main path's size through the installed service, with a store
    n, m = int(g.n), int(g.m)
    t0 = time.perf_counter()
    view = SM.host_view(g)
    t_view = time.perf_counter() - t0
    t0 = time.perf_counter()
    gfp = SM.graph_fingerprint(g, h, view=view)
    t_hash = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in (view.vwgt, view.rows, view.cols, view.ewgt))
    print(f"service (b) fingerprint of rgg n={n} m={m}: host fetch of the real slices "
          f"{t_view:.3f} s ({nbytes} B), blake2b {t_hash:.3f} s, {gfp.hex()}", flush=True)
    del view
    cfg = SharedMapConfig()
    with tempfile.TemporaryDirectory() as store:
        svc = SM.MappingService(store_path=store, device=dev)
        try:
            with svc.installed():
                r1, t1, ln = _run_path("service (b), rgg 2^20 through shared_map",
                                       lambda: shared_map(g, h, cfg, device=dev),
                                       MAPPING_KERNELS, _build)
                r2, t2 = timed(lambda: shared_map(g, h, cfg, device=dev))
        finally:
            svc.close()
        svc = SM.MappingService(store_path=store, device=dev)
        try:
            r3, t3 = timed(lambda: svc.map(g, h, cfg))
            st = svc.stats()["store"]
        finally:
            svc.close()
        entry_bytes = sum(p.stat().st_size for p in Path(store).glob("*.res"))
    if not (np.array_equal(r1.pe_of, pe_main) and r1.J == j_main == MAIN_PATH_J):
        raise AssertionError(f"service (b): J {r1.J} (phase 6: {j_main}, expected "
                             f"{MAIN_PATH_J}) or pe_of differs from phase 6's")
    if r1.stats["backend"] != "ell" or r1.stats["result_cache"]["hit"]:
        raise AssertionError("service (b): the first call was not an ell computation")
    if not (r2.stats["result_cache"]["hit"] and r3.stats["result_cache"]["hit"]
            and st["hits"] == 1):
        raise AssertionError(f"service (b): repeat or store read not a hit ({st})")
    for r, what in ((r2, "(b) cache hit"), (r3, "(b) store hit")):
        same(r, r1, what)
    print(f"service (b) rgg n={n} on {h} through the installed service: first call "
          f"{t1:.2f} s, J {r1.J} (phase 6's pe_of), launches {ln}; repeat (cache hit) "
          f"{t2:.3f} s; a second service on the store (store hit, an entry of "
          f"{entry_bytes} B) {t3:.3f} s, bit for bit", flush=True)
    del r1, r2, r3

    # (c) coalescing at scale, on the main path's hierarchy
    gc = [G.gen_rgg(SERVE_N_SCALE, seed=s, device=dev) for s in range(2)]
    cfg = SharedMapConfig()
    direct, t_seq = timed(lambda: [shared_map_direct(x, h, cfg, device=dev) for x in gc])
    svc = SM.MappingService(cache_entries=0, device=dev)
    try:
        out, t_burst = timed(lambda: [f.result() for f in svc.submit_many(
            [(x, h, cfg) for x in gc])])
        co = coalesced(dict.fromkeys(("dispatches", "groups", "members", "padded_lanes"), 0),
                       svc.stats()["coalesce"])
    finally:
        svc.close()
    for i, (a, b) in enumerate(zip(out, direct)):
        same(a, b, f"(c) request {i}")
    print(f"service (c) 2 x rgg {SERVE_N_SCALE} on {h}, default config: burst "
          f"{t_burst:.2f} s against two direct calls {t_seq:.2f} s (ratio "
          f"{t_burst / t_seq:.3f}); coalesce {co}; every pe_of equal", flush=True)

    # (d) worker mode on the card, on the cut hierarchy
    h = parse_hierarchy(*STRATEGY_HIERARCHY)
    direct = [shared_map_direct(x, h, cfg, device=dev) for x in gc]
    t0 = time.perf_counter()
    svc = SM.MappingService(workers=2, cache_entries=0, device=dev)
    try:
        t_pool = time.perf_counter() - t0
        futs = [svc.submit(gc[i], h, cfg) for i in (0, 1)]
        concurrent.futures.wait(futs, return_when=concurrent.futures.FIRST_COMPLETED)
        t_first = time.perf_counter() - t0
        out = [f.result() for f in futs]
        t_both = time.perf_counter() - t0
    finally:
        svc.close()
    for i, r in enumerate(out):
        if r.stats["backend"] != "ell":
            raise AssertionError(f"service (d): worker backend {r.stats['backend']!r}")
        same(r, direct[i], f"(d) worker request {i}")
    inj = FaultInjector(fail_at={"worker_kill": (0,)})
    svc = SM.MappingService(workers=1, cache_entries=0, fault_injector=inj, device=dev)
    try:
        r, t_kill = timed(lambda: svc.map(gc[1], h, cfg))
        ws = svc.stats()["workers"]
    finally:
        svc.close()
    same(r, direct[1], "(d) request of the killed worker")
    if not (ws["killed_injected"] == 1 and ws["restarts"] >= 1 and ws["redispatched"] >= 1
            and r.stats["backend"] == "ell"):
        raise AssertionError(f"service (d): kill not recovered as expected: {ws}")
    print(f"service (d) two workers on the card, {h}: pool started in {t_pool:.2f} s, "
          f"spawn to first result {t_first:.2f} s, both {t_both:.2f} s, backend ell, "
          f"pe_of equal; a worker killed on its first dispatch: resolved in "
          f"{t_kill:.2f} s bit for bit, workers {ws}", flush=True)

    # (e) shadow verification of the device strategy
    svc = SM.MappingService(shadow_verify_fraction=1.0, device=dev)
    try:
        r, t_dev = timed(lambda: svc.map(gc[0], h, SharedMapConfig(strategy="device")))
    finally:
        svc.close(wait=True)   # drains the shadow job
    sh = svc.stats()["shadow"]
    if (sh["sampled"], sh["matched"], sh["device_quarantined"]) != (1, 1, False):
        raise AssertionError(f"service (e): shadow verification {sh}")
    print(f"service (e) device strategy rgg {SERVE_N_SCALE} on {h} with shadow verification: "
          f"request {t_dev:.2f} s, shadow {sh}, J {r.J}", flush=True)
    del gc, direct, out


HLO_DIR = ROOT / "tests" / "data" / "hlo"
HLO_FIXTURES = ("whisper_tiny_train", "xlstm_125m_train")   # written by make_hlo_fixtures.py
SEGMENT_K, SEGMENT_EPS, SEGMENT_SALT = 4, 0.03, 1   # benchmarks/run.py:bench_coarsen_kernels


def _ingestion_path(dev, g, deg_root, _build) -> None:
    """Phase 9: HLO ingestion and the closed loop, the segment path, and the
    coarsening cascade at the main path's size (see the module doc)."""
    import gzip
    import hashlib
    import warnings

    import numpy as np
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core.api import SharedMapConfig, shared_map, shared_map_direct
    from repro_torch.core.coarsen import coarsen_cascade
    from repro_torch.core.hierarchy import parse_hierarchy
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.core.partition import _coarsen_levels, num_levels, partition_host
    from repro_torch.launch import comm_graph as CG
    from repro_torch.launch import mesh as MESH

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) the model fixtures: extraction, then the mapping on the card
    h = MESH.physical_hierarchy(False)
    no_lp = [k for k in MAPPING_KERNELS if k != "lp_gain"]
    for stem in HLO_FIXTURES:
        with gzip.open(HLO_DIR / f"{stem}.hlo.txt.gz") as f:
            text = f.read().decode()
        side = json.loads((HLO_DIR / f"{stem}.json").read_text())
        t0 = time.perf_counter()
        tg = CG.extract_comm_graph(text, side["trip_hints"], min_tasks=side["min_tasks"])
        t_ext = time.perf_counter() - t0
        got = (tg.fingerprint().hex(), tg.n, tg.m, tg.meta["granularity"])
        want = (side["fingerprint"], side["n"], side["m"], side["granularity"])
        if got != want:
            raise AssertionError(f"{stem}: extracted {got}, the sidecar holds {want}")
        gt = tg.to_graph(device=dev)
        j_def = evaluate_J(gt, h, CG.default_placement(tg.n, h.k), device=dev)
        line = []
        for backend, expect in (("ell", MAPPING_KERNELS), ("xla", no_lp)):
            cfg = SharedMapConfig(preset="fast", backend=backend)
            r, sec, ln = _run_path(f"closed loop {stem} {backend}",
                                   lambda: shared_map_direct(tg, h, cfg, device=dev),
                                   expect, _build)
            rc = shared_map_direct(tg, h, cfg, device="cpu")
            if r.pe_of.dtype != rc.pe_of.dtype or not np.array_equal(r.pe_of, rc.pe_of):
                raise AssertionError(f"{stem} {backend}: the card's pe_of differs from the CPU's "
                                     f"(J {r.J!r} / {rc.J!r})")
            if not r.J < j_def:
                raise AssertionError(f"{stem} {backend}: J {r.J} not below the default "
                                     f"placement's {j_def}")
            if backend == "xla":
                digest = hashlib.blake2b(np.ascontiguousarray(r.pe_of[: tg.n]).tobytes(),
                                         digest_size=16).hexdigest()
                if digest != side["pe_of_blake2b"] or abs(r.J - side["J_xla_fast"]) > \
                        1e-5 * side["J_xla_fast"]:
                    raise AssertionError(f"{stem} xla: pe_of or J {r.J!r} is not the "
                                         f"sidecar's ({side['J_xla_fast']!r})")
            line.append(f"{backend}: mapping {sec:.2f} s, J {r.J!r}, J/J_default "
                        f"{r.J / j_def:.4f}, pe_of equal to the CPU's"
                        + (" and the JAX package's (sidecar)" if backend == "xla" else "")
                        + f", launches {ln}")
        print(f"closed loop {side['arch']} ({stem}): {tg.n} tasks, {tg.m} edges "
              f"({tg.meta['granularity']}), extraction {t_ext:.3f} s, on {h} k={h.k}, fast; "
              f"J_default {j_def!r}; " + "; ".join(line), flush=True)
    t0 = time.perf_counter()
    perm = MESH.sharedmap_device_order(False)
    t_perm = time.perf_counter() - t0
    gl = MESH.logical_comm_graph(False).to_graph(device=dev)
    j_sm = evaluate_J(gl, h, perm, device=dev)
    j_row = evaluate_J(gl, h, np.arange(h.k, dtype=np.int32), device=dev)
    if j_sm > j_row:
        raise AssertionError(f"sharedmap_device_order: J {j_sm} above the default order's {j_row}")
    print(f"sharedmap_device_order(False): {t_perm:.3f} s on the host, J {j_sm!r} against the "
          f"default order's {j_row!r} on {h}, {int((perm != np.arange(h.k)).sum())} chips "
          f"moved", flush=True)

    # (b) the segment coarsening path: card against CPU, then full size
    def part_host(graph, backend, coarsen, device):
        return partition_host(graph, SEGMENT_K, SEGMENT_EPS, "fast", SEGMENT_SALT, backend,
                              coarsen, device=device)
    for name, gs in (("grid 32x32", G.gen_grid(32, device="cpu")),
                     ("rgg 2000", G.gen_rgg(2000, seed=3, device="cpu"))):
        for backend in ("ell", "xla"):
            for weights, gw in (("unit", gs), ("float", G.float_weights(gs, seed=7))):
                cards = [part_host(gw, backend, "segment", dev) for _ in range(2)]
                cpu = part_host(gw, backend, "segment", "cpu")
                if not (torch.equal(cards[0], cards[1]) and torch.equal(cards[0].cpu(), cpu)):
                    raise AssertionError(f"segment path, {name} {weights} {backend}: the card's "
                                         "partitions differ from each other or from the CPU's")
        print(f"segment path {name}, k={SEGMENT_K}: partition_host(coarsen='segment') equal on "
              f"card (two runs) and CPU under ell and xla, unit and float weights", flush=True)
    for name, make in (("grid 317x317", lambda: G.gen_grid(317, device=dev)),
                       ("rgg 100000", lambda: G.gen_rgg(100_000, seed=1, device=dev))):
        gs = make()
        lmax = (1.0 + SEGMENT_EPS) * float(gs.total_weight()) / SEGMENT_K
        row = []
        for coarsen in ("ell", "segment"):
            p, sec, ln = _run_path(f"partition_host {name} {coarsen}",
                                   lambda: part_host(gs, "auto", coarsen, dev),
                                   ["lp_gain"] + (["hem_propose", "contract_edges"]
                                                  if coarsen == "ell" else []), _build)
            if coarsen == "segment" and ln["hem_propose"] + ln["contract_edges"]:
                raise AssertionError(f"segment path {name}: the coarsening kernels launched")
            cut = float(G.edge_cut(gs, p))
            big = float(G.block_weights(gs, p, SEGMENT_K).max()) / lmax
            row.append(f"{coarsen} {sec:.2f} s, cut {cut!r}, largest block / Lmax {big:.4f}")
        print(f"partition_host {name} n={int(gs.n)} m={int(gs.m)}, k={SEGMENT_K}, fast, salt "
              f"{SEGMENT_SALT}, auto (ell): " + "; ".join(row), flush=True)
        del gs

    # (c) the cascade at the main path's size, one fetch, two kernels
    n, m = int(g.n), int(g.m)
    lv = num_levels(n, parse_hierarchy(*HIERARCHY).a[-1])
    def cascade():   # every synchronizing call inside it raises a warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return coarsen_cascade(g, lv, ell_deg=deg_root, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (ns, ms), sec, ln = _run_path("coarsen_cascade rgg 2^20", cascade,
                                      ["hem_propose", "contract_edges"], _build)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    others = {k: v for k, v in ln.items() if v and k not in ("hem_propose", "contract_edges")}
    if len(syncs) != 1 or others:
        raise AssertionError(f"coarsen_cascade: {len(syncs)} synchronizing calls {syncs[:3]}, "
                             f"other kernels {others}")
    fines, _, coarsest = _coarsen_levels(g, lv, deg_root)
    sizes = [(int(x.n), int(x.m)) for x in fines[1:] + [coarsest]]
    del fines, coarsest
    if sizes != list(zip(ns.tolist(), ms.tolist())):
        raise AssertionError(f"coarsen_cascade sizes {list(zip(ns, ms))} are not the "
                             f"v-cycle's {sizes}")
    print(f"coarsen_cascade rgg n={n} m={m}, {lv} levels, ELL cap {deg_root}: {sec:.3f} s, one "
          f"synchronizing fetch, launches hem_propose {ln['hem_propose']} contract_edges "
          f"{ln['contract_edges']}; sizes equal to the v-cycle's fine graphs: n "
          f"{ns.tolist()}", flush=True)
    g6 = G.gen_grid(1000, device=dev)
    n6, m6 = int(g6.n), int(g6.m)
    lv6, deg6 = num_levels(n6, 4), G.default_ell_deg(n6, m6)
    coarsen_cascade(g6, 1, ell_deg=deg6, device=dev)    # the allocator's first blocks
    (ns6, _), sec6 = timed(lambda: coarsen_cascade(g6, lv6, ell_deg=deg6, device=dev))
    shrink = np.round(np.concatenate([[n6], ns6[:-1]]) / np.maximum(ns6, 1), 3).tolist()
    print(f"coarsen_cascade grid 1000x1000 (the 10^6 tier) n={n6} m={m6}, {lv6} levels, cap "
          f"{deg6}: {sec6:.3f} s, shrink per level {shrink}, coarsest n {int(ns6[-1])}",
          flush=True)
    del g6
    gsm = G.gen_grid(32, device="cpu")
    small_h = parse_hierarchy("4:2", "1:10")
    cfg = SharedMapConfig(coarsen_telemetry=True)
    a = shared_map(gsm, small_h, cfg, device=dev).stats["coarsen"]
    b = shared_map(gsm, small_h, cfg, device="cpu").stats["coarsen"]
    if a != b:
        raise AssertionError(f"stats['coarsen'] on the card {a} differs from the CPU's {b}")
    print(f"coarsen_telemetry grid 32x32 on {small_h}: stats['coarsen'] equal on card and "
          f"CPU: {a}", flush=True)


# phase 9 (d): the port's own train cells, exported and mapped. xlstm-125m cut
# from seq 64 (26.4 s of export on a sandbox host) to 16 for the smoke's time.
# The exports run in a process of their own from the smoke's start (host
# Python on meta tensors, no card), so the card's phases hide their 40-60 s.
EXPORT_CELLS = (("whisper-tiny", 64, 4), ("xlstm-125m", 16, 4))
HLO_J_RATIO = {"whisper-tiny": 0.3344, "xlstm-125m": 0.0654}   # phase 9 (a), PR 19
EXPORT_FLOP_RTOL = 0.005
EXPORT_MIN_TASKS = 512    # 2k on physical_hierarchy(False)


def _export_worker(out_dir: str) -> int:
    """``chip_smoke.py --export-cells DIR``: export and extract each of
    EXPORT_CELLS on the host (``compile_model_cell``, ``extract_fx_graph``
    at EXPORT_MIN_TASKS) and write its task graph and timings to DIR."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.launch import comm_graph as CG
    from repro_torch.launch import fx_analysis as FX
    for arch, S, B in EXPORT_CELLS:
        t0 = time.perf_counter()
        exported, _ = CG.compile_model_cell(arch, seq_len=S, batch=B)
        t_exp = time.perf_counter() - t0
        t0 = time.perf_counter()
        tg = CG.extract_fx_graph(exported, min_tasks=EXPORT_MIN_TASKS,
                                 meta={"arch": arch, "seq_len": S, "batch": B})
        t_ext = time.perf_counter() - t0
        np.savez(Path(out_dir) / f"{arch}.npz", u=tg.u, v=tg.v, w=tg.w, vwgt=tg.vwgt)
        (Path(out_dir) / f"{arch}.json").write_text(json.dumps({
            "n": tg.n, "meta": tg.meta, "fingerprint": tg.fingerprint().hex(),
            "export_s": t_exp, "extract_s": t_ext,
            "flops": FX.total_flops(exported.graph)}))
    return 0


def _start_exports(out_dir: str):
    """Start the export worker (no card: CUDA hidden from it)."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--export-cells",
                             out_dir], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _export_path(dev, _build, worker, out_dir: str) -> None:
    """Phase 9 (d): the port's own graphs (from the export worker), mapped on
    16:16, fast, under ``ell`` (the five mapping kernels launch) and ``xla``
    pinned: the card's ``pe_of`` equals the CPU's; xlstm-125m's J is below
    the default placement's; whisper-tiny's FLOPs equal its HLO fixture's."""
    import gzip

    import numpy as np
    from repro_torch.core.api import SharedMapConfig, shared_map_direct
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.core.taskgraph import TaskGraph
    from repro_torch.launch import comm_graph as CG
    from repro_torch.launch import mesh as MESH

    t0 = time.perf_counter()
    log, _ = worker.communicate(timeout=600)
    if worker.returncode != 0:
        raise AssertionError(f"export worker exited {worker.returncode}: {log[-3000:]}")
    print(f"export worker: waited {time.perf_counter() - t0:.2f} s for it here", flush=True)
    h = MESH.physical_hierarchy(False)
    assert 2 * h.k == EXPORT_MIN_TASKS
    no_lp = [k for k in MAPPING_KERNELS if k != "lp_gain"]
    for arch, S, B in EXPORT_CELLS:
        info = json.loads((Path(out_dir) / f"{arch}.json").read_text())
        with np.load(Path(out_dir) / f"{arch}.npz") as a:
            tg = TaskGraph.from_edges(info["n"], a["u"], a["v"], a["w"], vwgt=a["vwgt"],
                                      meta=info["meta"])
        if tg.fingerprint().hex() != info["fingerprint"]:
            raise AssertionError(f"export {arch}: the graph changed on its way from the worker")
        note = ""
        if arch == "whisper-tiny":   # the HLO fixture is this cell (seq 64, batch 4)
            with gzip.open(HLO_DIR / "whisper_tiny_train.hlo.txt.gz") as f:
                text = f.read().decode()
            side = json.loads((HLO_DIR / "whisper_tiny_train.json").read_text())
            ref = CG.extract_comm_graph(text, side["trip_hints"], min_tasks=side["min_tasks"])
            want = float(ref.vwgt.astype(np.float64).sum())
            got = float(tg.vwgt.astype(np.float64).sum())
            if abs(got - want) > EXPORT_FLOP_RTOL * want:
                raise AssertionError(f"{arch}: export FLOPs {got!r}, the HLO fixture's {want!r}")
            note = f"; sum of vwgt {got:.6g} against the HLO fixture's {want:.6g}"
        gt = tg.to_graph(device=dev)
        j_def = evaluate_J(gt, h, CG.default_placement(tg.n, h.k), device=dev)
        line = []
        for backend, expect in (("ell", MAPPING_KERNELS), ("xla", no_lp)):
            cfg = SharedMapConfig(preset="fast", backend=backend)
            r, sec, ln = _run_path(f"export {arch} {backend}",
                                   lambda: shared_map_direct(tg, h, cfg, device=dev),
                                   expect, _build)
            rc = shared_map_direct(tg, h, cfg, device="cpu")
            if r.pe_of.dtype != rc.pe_of.dtype or not np.array_equal(r.pe_of, rc.pe_of):
                raise AssertionError(f"export {arch} {backend}: the card's pe_of differs from "
                                     f"the CPU's (J {r.J!r} / {rc.J!r})")
            # whisper-tiny's unembed task holds 54% of the FLOPs, more than a
            # top-level block may: the balance constraint places its neighbours
            # apart, and J lies above program order's (on the CPU and in the
            # reference alike, tests/test_torch_model_graphs.py)
            if arch != "whisper-tiny" and not r.J < j_def:
                raise AssertionError(f"export {arch} {backend}: J {r.J} not below the default "
                                     f"placement's {j_def}")
            line.append(f"{backend}: mapping {sec:.2f} s, J {r.J!r}, J/J_default "
                        f"{r.J / j_def:.4f}, pe_of equal to the CPU's, launches {ln}")
        print(f"export {arch} seq {S} batch {B}: torch.export {info['export_s']:.2f} s on the "
              f"host (in the worker), extraction {info['extract_s']:.3f} s, {tg.n} tasks, "
              f"{tg.m} edges ({tg.meta['granularity']}), dot FLOPs {info['flops']:.6g}{note}; "
              f"on {h} k={h.k}, fast; J_default {j_def!r} (the HLO fixture's J/J_default "
              f"{HLO_J_RATIO[arch]}); " + "; ".join(line), flush=True)

QUALITY = ("shared_map(tg)", "refine_mapping", "global_multisection", "kaffpa_map_style",
           "random_mapping", "greedy_baseline")
KAFFPA_HIERARCHY = ("4:8:4", "1:10:100")   # k = 128: the nearest paper hierarchy with k = 2^j
MAIN_PATH_J = 1_698_496    # J of the main path (rgg 2^20 on 4:8:6) under ell
MAIN_PATH_J_XLA = 1_385_053   # and under xla pinned
# phase 8 (a): benchmarks/run.py:bench_serve at its full size
SERVE_R, SERVE_N, SERVE_H = 24, 64, ("2:2:2:2", "1:5:10:100")
# (c)-(e): the requests coalesced, sent to workers, shadowed; cut from 2^16
# (371 s for phase 8 there), then from four requests at 2^15 to two at 2^14;
# (d) and (e) from 4:8:6 to STRATEGY_HIERARCHY, to fit the smoke's time limit
SERVE_N_SCALE = 2**14


def _quality_run(alg, g, h, device, backend="auto"):
    """One algorithm of the paper's quality comparison (the JAX package's
    ``benchmarks/run.py:quality_profiles``) on ``device``: ``(result, pe_of,
    J)``. ``g`` is a Graph, or a TaskGraph for the two SharedMap runs."""
    from repro_torch.core import baselines as B
    from repro_torch.core.api import SharedMapConfig, shared_map
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.core.taskgraph import TaskGraph
    if alg in ("shared_map(tg)", "refine_mapping"):
        tg = g if isinstance(g, TaskGraph) else TaskGraph.from_graph(g)
        cfg = SharedMapConfig(backend=backend, refine_mapping=alg == "refine_mapping")
        r = shared_map(tg, h, cfg, device=device)
        return r, r.pe_of, r.J
    if alg in ("random_mapping", "greedy_baseline"):
        pe = getattr(B, alg)(g, h, device=device)
        return None, pe, evaluate_J(g, h, pe, device=device)
    r = getattr(B, alg)(g, h, backend=backend, device=device)
    return r, r.pe_of, r.stats["J_after_refine"]


def _quality_small(dev) -> None:
    """Phase 7a: the quality comparison on the small instances of phase 3,
    card against CPU with the backend pinned on both sides: the same
    ``pe_of``, dtype included, and J within ``mapcost``'s rtol."""
    import numpy as np
    from repro_torch.core import graph as G
    from repro_torch.core.hierarchy import parse_hierarchy
    small_h = parse_hierarchy("4:2", "1:10")
    for name, gs in (("grid 32x32", G.gen_grid(32, device="cpu")),
                     ("rgg 2000", G.gen_rgg(2000, seed=3, device="cpu"))):
        for backend in ("ell", "xla"):
            for alg in QUALITY:
                if alg == "random_mapping":
                    continue   # host numpy only
                t0 = time.perf_counter()
                _, pa, ja = _quality_run(alg, gs, small_h, dev, backend)
                t_card = time.perf_counter() - t0
                _, pb, jb = _quality_run(alg, gs, small_h, "cpu", backend)
                if pa.dtype != pb.dtype or not np.array_equal(pa, pb):
                    raise AssertionError(f"quality, small {name} {backend} {alg}: the card's "
                                         f"pe_of ({pa.dtype}) differs from the CPU's "
                                         f"({pb.dtype})")
                if abs(ja - jb) > 1e-5 * abs(jb):
                    raise AssertionError(f"quality, small {name} {backend} {alg}: J {ja} on "
                                         f"the card, {jb} on the CPU")
                print(f"quality, small {name} on {small_h}, backend {backend}, {alg}: pe_of "
                      f"({pa.dtype}) equal on card and CPU, J {ja!r} / {jb!r}, card "
                      f"{t_card:.2f} s", flush=True)


def _quality_main(dev, g, tg, gt, h, res_sm, t_sm, every, _build) -> None:
    """Phase 7b: the quality comparison at the main path's size. SharedMap's
    run is phase 6's on the TaskGraph (``res_sm``, ``t_sm`` seconds); the
    baselines run on its CSR ``gt``; KaFFPa-map needs k = 2^j, so it runs on
    4:8:4 beside a SharedMap run there."""
    import numpy as np
    import torch
    from repro_torch.core.hierarchy import parse_hierarchy
    from repro_torch.core.mapping import quotient_matrix, swap_refine
    n = int(g.n)
    table = [("shared_map(tg)", h, t_sm, res_sm.J, res_sm.J, None)]

    def run(alg, graph, hh, expect):
        (r, pe, j), sec, ln = _run_path(f"quality {alg}", lambda: _quality_run(alg, graph, hh, dev),
                                        expect, _build)
        if pe.shape != (n,) or pe.min() < 0 or pe.max() >= hh.k:
            raise AssertionError(f"quality {alg}: pe_of out of range")
        return r, pe, j, sec, ln

    r, pe, j, sec, ln = run("refine_mapping", tg, h, every)
    if not (r.stats.get("refined") and pe.dtype == np.int32):
        raise AssertionError("refine_mapping: not refined, or pe_of not int32")
    if j > res_sm.J:
        raise AssertionError(f"refine_mapping: J {j} above SharedMap's {res_sm.J}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C = quotient_matrix(gt, res_sm.pe_of, h.k)
    t_q = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm = swap_refine(C, h, np.arange(h.k, dtype=np.int32), seed=0)
    t_s = time.perf_counter() - t0
    if not np.array_equal(perm[res_sm.pe_of], pe):   # the same multisection, then the swaps
        raise AssertionError("refine_mapping: not SharedMap's pe_of under the swap pass")
    print(f"quality: host numpy at k={h.k} on SharedMap's partition: quotient_matrix "
          f"{t_q:.3f} s ({int(g.m)} directed edges), swap_refine {t_s:.3f} s, "
          f"{int((perm != np.arange(h.k)).sum())} PEs moved", flush=True)
    table.append(("refine_mapping", h, sec, j, res_sm.J, ln))
    r, pe, j, sec, ln = run("global_multisection", gt, h, every)
    if r.stats["backend"] != "ell" or pe.dtype != np.int64:
        raise AssertionError(f"global_multisection: backend {r.stats['backend']!r}, "
                             f"pe_of {pe.dtype}")
    print(f"quality global_multisection: J before the swaps {r.stats['J_before_refine']}, "
          f"after {r.stats['J_after_refine']}, partition calls {r.stats['partition_calls']}",
          flush=True)
    table.append(("global_multisection", h, sec, j, res_sm.J, ln))
    for alg in ("random_mapping", "greedy_baseline"):
        _, pe, j, sec, ln = run(alg, gt, h, [])
        table.append((alg, h, sec, j, res_sm.J, ln))
    h4 = parse_hierarchy(*KAFFPA_HIERARCHY)
    _, _, j4, sec4, ln4 = run("shared_map(tg)", tg, h4, every)
    table.append(("shared_map(tg)", h4, sec4, j4, j4, ln4))
    r, pe, j, sec, ln = run("kaffpa_map_style", gt, h4, every)
    table.append(("kaffpa_map_style", h4, sec, j, j4, ln))
    for alg, hh, sec, j, j_sm, ln in table:
        print(f"quality rgg n={n} on {hh}, default config (ell on the card): {alg} "
              f"{sec:.2f} s, J {j!r}, J over SharedMap's {j / j_sm:.4f}"
              + (f", launches {ln}" if ln else ""), flush=True)


# ---- phase 12: training ---------------------------------------------------------
TRAIN_ARCHS = ("llama3.2-3b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b", "xlstm-125m",
               "whisper-tiny", "internvl2-76b")
TRAIN_LOSS_RTOL_F32 = 1e-5    # tests/test_torch_train.py: f32, card against CPU
TRAIN_LEAF_RTOL_F32 = 1e-4    # relative L2 per leaf
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 2048, 3    # (d): llama3.2-3b at full width
# remat "none" keeps every layer's activations (~1.5 GB a layer at 1 x 2048,
# reckoned): 28 layers would pass 75 GB beside the 43 GB of params, mu and nu,
# so that run, and a "full" one beside it, cut the depth to 14 layers
TRAIN_CUT_LAYERS = 14


def _f32_compute(on: bool):
    """Set the port's compute dtype to float32 (``on``) or back to bf16 in
    every module that reads it (as the CPU tests do)."""
    import importlib
    import torch
    for m in ("layers", "model", "transformer", "whisper"):
        setattr(importlib.import_module(f"repro_torch.models.{m}"), "CDTYPE",
                torch.float32 if on else torch.bfloat16)


def _train_small(dev) -> None:
    """Phase 12 (a): each family's smoke config, card against CPU from one
    seeded init: loss and every gradient in f32, the loss in bf16."""
    import copy

    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as MM
    from repro_torch.train.train_step import loss_and_grads, train_state

    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        S = cfg.num_patches + 16 if cfg.frontend == "vision_stub" else 16
        b_cpu = make_batch(cfg, DataConfig(S, 2, seed=1), 0, "cpu")
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        p_cpu = train_state(MM.init_fn(cfg, torch.Generator(device="cpu").manual_seed(0))).params
        p_dev = copy.deepcopy(p_cpu).to(dev)
        _f32_compute(True)
        try:
            l_cpu, g_cpu = loss_and_grads(cfg, p_cpu, b_cpu)
            l_dev, g_dev = loss_and_grads(cfg, p_dev, b_dev)
        finally:
            _f32_compute(False)
        if abs(float(l_dev) - float(l_cpu)) > TRAIN_LOSS_RTOL_F32 * abs(float(l_cpu)):
            raise AssertionError(f"{arch} smoke f32 loss: card {float(l_dev)!r}, CPU "
                                 f"{float(l_cpu)!r}")
        errs = []
        for k, g in g_cpu.items():
            a, b = g_dev[k].double().cpu(), g.double()
            errs.append((float((a - b).norm() / b.norm().clamp_min(1e-30)), k))
        worst = max(errs)
        if not worst[0] < TRAIN_LEAF_RTOL_F32:
            raise AssertionError(f"{arch} smoke f32 gradients: {worst[1]} {worst[0]:.3g} apart "
                                 f"(relative L2; limit {TRAIN_LEAF_RTOL_F32})")
        lb_cpu, _ = loss_and_grads(cfg, p_cpu, b_cpu)
        lb_dev, gb_dev = loss_and_grads(cfg, p_dev, b_dev)
        _held(f"{arch} smoke bf16 loss", lb_dev, lb_cpu)
        if not all(torch.isfinite(g).all() for g in gb_dev.values()):
            raise AssertionError(f"{arch} smoke bf16 gradients: not finite")
        print(f"{arch} smoke train cell, card against CPU: f32 loss {float(l_dev):.7f} / "
              f"{float(l_cpu):.7f}, {len(errs)} gradient leaves, worst relative L2 "
              f"{worst[0]:.3g} ({worst[1]}; limits rtol {TRAIN_LOSS_RTOL_F32}, "
              f"{TRAIN_LEAF_RTOL_F32}); bf16 loss {float(lb_dev):.5f} / {float(lb_cpu):.5f} "
              f"(atol {LOGITS_ATOL} rtol {LOGITS_RTOL})", flush=True)


def _train_restart(dev) -> None:
    """Phase 12 (b): six steps straight equal three, a checkpoint, a restore
    into another init and three more, bit for bit on the card."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_smoke_config(ARCH)
    dc = DataConfig(seq_len=16, global_batch=4, seed=1)
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=8, warmup_steps=1))

    def run(steps, state):
        for s in steps:
            state, _ = step_fn(state, make_batch(cfg, dc, s, dev))
        return state

    def differing(a, b):
        out = [k for (k, x), y in zip(a.params.named_parameters(), b.params.parameters())
               if not torch.equal(x, y)]
        return out + [f"mu/{k}" for k in a.opt.mu if not torch.equal(a.opt.mu[k], b.opt.mu[k])]

    t0 = time.perf_counter()
    straight = run(range(6), init_train_state(cfg, 0, dev))
    again = run(range(6), init_train_state(cfg, 0, dev))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        state = run(range(3), init_train_state(cfg, 0, dev))
        ck.save(3, {"params": state.params, "opt": state.opt})
        ck.wait()
        tmpl = init_train_state(cfg, 5, dev)
        back = ck.restore(3, {"params": tmpl.params, "opt": tmpl.opt})
        resumed = run(range(3, 6), tmpl._replace(params=back["params"], opt=back["opt"]))
    bad = {"a second straight run": differing(straight, again),
           "the restart": differing(straight, resumed)}
    if any(bad.values()):
        raise AssertionError(f"restart on the card: leaves that differ from the straight run "
                             f"{ {k: v[:6] for k, v in bad.items()} }")
    print(f"{cfg.name} train restart on the card: 6 steps straight == 3 steps, checkpoint, "
          f"restore into another init, 3 steps, bit for bit (params, mu, nu; a second "
          f"straight run too), {time.perf_counter() - t0:.2f} s", flush=True)


def _train_driver(dev) -> None:
    """Phase 12 (c): ``python -m repro_torch.launch.train`` on the card with an
    injected failure: one restart, and a final loss below the first."""
    import os
    import re

    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
               "--steps", "40", "--fail-at", "15", "--checkpoint-every", "5",
               "--checkpoint-dir", os.path.join(d, "run")]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
        sec = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"launch.train exited {out.returncode}: {out.stderr[-2000:]}")
    log = out.stdout
    losses = [float(x) for x in re.findall(r"^step\s+\d+ loss (\S+)", log, re.M)]
    done = re.search(r"\[done\] final loss (\S+)", log)
    if log.count("[restart #") != 1 or "[restore] resumed from step 10" not in log or not done:
        raise AssertionError(f"launch.train: expected one restart from step 10:\n{log[-2000:]}")
    final = float(done.group(1))
    if not final < losses[0]:
        raise AssertionError(f"launch.train: final loss {final} not below the first {losses[0]}")
    speed = re.findall(r"^step\s+39 .* (\S+) ms/step\s+(\S+) tok/s", log, re.M)
    print(f"launch.train {ARCH} --smoke --steps 40 --fail-at 15 --checkpoint-every 5 on the "
          f"card: one restart (resumed from step 10), loss {losses[0]:.4f} at step 0, final "
          f"{final:.4f}; last step {speed[0] if speed else '?'} (ms, tok/s); {sec:.1f} s "
          f"with the process's start", flush=True)


def _train_full(dev) -> None:
    """Phase 12 (d): llama3.2-3b at full width, B 1 x S 2048, three AdamW steps
    under remat full and dots (28 layers) and none (TRAIN_CUT_LAYERS, beside
    full at the same depth); step 1's loss equals loss_fn under no_grad."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as MM
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step, train_state

    full = get_config(ARCH)
    print(f"{ARCH} training memory reckoned: {full.param_count()} params x 16 B (params, "
          f"grads, mu, nu) = {full.param_count() * 16 / 1e9:.1f} GB before activations",
          flush=True)
    dc = DataConfig(TRAIN_S, TRAIN_B, seed=0)
    for remat, layers in (("full", 0), ("dots", 0), ("none", TRAIN_CUT_LAYERS),
                          ("full", TRAIN_CUT_LAYERS)):
        cfg = dataclasses.replace(full, num_layers=layers) if layers else full
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = train_state(MM.init_fn(cfg, torch.Generator(device=dev).manual_seed(0)))
        ctx = ShardCtx(remat=remat)
        step = make_train_step(cfg, AdamWConfig(), ctx)
        batches = [make_batch(cfg, dc, s, dev) for s in range(TRAIN_STEPS)]
        if remat == "full" and not layers:
            with torch.no_grad():
                eval_loss = float(MM.loss_fn(cfg, state.params, batches[0]))
        secs, losses = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if not all(map(lambda x: x == x and abs(x) < 1e3, losses)):
            raise AssertionError(f"{ARCH} full-width training: losses {losses}")
        if remat == "full" and not layers and \
                abs(losses[0] - eval_loss) > 1e-6 * abs(eval_loss):
            raise AssertionError(f"{ARCH} full width: step 1's loss {losses[0]!r}, loss_fn "
                                 f"under no_grad {eval_loss!r}")
        s_step = statistics.median(secs[1:])
        if remat == "full" and not layers:   # one more step, profiled
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=acts) as prof:
                step(state, batches[0])
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(e.self_device_time_total for e in events)
            print(f"profile: {ARCH} train step, remat full: wall {wall:.3f} s under the "
                  f"profiler, device busy {busy_us / 1e6:.3f} s "
                  f"({100 * busy_us / 1e6 / wall:.1f}%), {sum(e.count for e in events)} "
                  f"device ops", flush=True)
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
                print(f"profile:   {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
                      f"{e.key[:90]}", flush=True)
            del prof, events
        print(f"{ARCH} train step at full width ({cfg.num_layers} layers"
              + (f", cut from {full.num_layers}" if layers else "") + f"), B {TRAIN_B} x S "
              f"{TRAIN_S}, remat {remat}: steps {[round(s, 3) for s in secs]} s, "
              f"{s_step:.3f} s/step (median of steps 2-{TRAIN_STEPS}), "
              f"{TRAIN_B * TRAIN_S / s_step:.0f} tok/s, peak memory {peak} B, losses "
              f"{[round(x, 5) for x in losses]}"
              + (f"; step 1's loss equals loss_fn under no_grad ({eval_loss!r}) within rtol "
                 f"1e-6" if remat == "full" and not layers else ""), flush=True)
        del state, step, batches
    torch.cuda.empty_cache()


def _train_path(dev) -> None:
    """Phase 12: training (see the module doc)."""
    t0 = time.perf_counter()
    _train_small(dev)
    t_a = time.perf_counter() - t0
    _train_restart(dev)
    t_b = time.perf_counter() - t0 - t_a
    _train_driver(dev)
    t_c = time.perf_counter() - t0 - t_a - t_b
    _train_full(dev)
    total = time.perf_counter() - t0
    print(f"phase 12: {total:.1f} s in all ((a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) {t_c:.1f} s, "
          f"(d) {total - t_a - t_b - t_c:.1f} s)", flush=True)


# ---- phase 14: the multi-device launch/ pieces -------------------------------------
# (a) the dry-run's cells, recorded by a worker process from the smoke's start
# (host Python on meta DTensors over a fake world of 256 ranks, no card); the
# worker also maps llama's graph on the CPU under ell and xla pinned, so the
# card's pe_of has its CPU twin when phase 14 comes
# llama3.2-3b x decode_32k: its 8 kv heads do not divide the 16 model ranks,
# so the KV cache is sharded over the sequence and no all-gather may move it;
# llama3.2-3b x train_4k and qwen2-72b x prefill_32k: nor do they divide them
# in attention, which each rank runs on its (batch row, kv group) units;
# jamba-v0.1-52b x prefill_32k: Mamba's SSD on each rank's heads;
# xlstm-125m x train_4k: its sLSTM time scans recorded as loop regions;
# whisper-tiny x train_4k on pod2 (512 ranks: the batch over pod and data),
# recorded by a second worker, since the fake process group is process-global
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", "pod1"), ("xlstm-125m", "train_4k", "pod1"),
                ("moonshot-v1-16b-a3b", "decode_32k", "pod1"),
                ("llama3.2-3b", "decode_32k", "pod1"), ("qwen2-72b", "prefill_32k", "pod1"),
                ("jamba-v0.1-52b", "prefill_32k", "pod1"),
                ("whisper-tiny", "train_4k", "pod2"))
DRYRUN_TOP = 5                            # products printed per cell
# the cells whose per-rank graph is mapped (on the CPU in the worker, then on
# the card): xlstm's with its loop regions' trips on its tasks and edges
DRYRUN_MAP_CELLS = (("llama3.2-3b", "train_4k", "pod1"), ("xlstm-125m", "train_4k", "pod1"))
DRYRUN_FIXTURES = ROOT / "tests" / "data" / "dryrun"
# each fixture cell's per-device FLOPs over the reference's, as measured, and
# the relative band it is held within (tests/test_torch_dryrun.py holds the
# same under the CPU's torch); useful_ratio (model FLOPs over every rank's)
# at most 1 in every cell
DRYRUN_FLOPS_RATIO = DRYRUN_FIXTURES / "flops_ratio.json"
# (c) one MoE layer at full width, V = 16 shards summed in shard order against
# V = 1 on the same weights, every token kept (capacity factor E / top_k);
# tokens per layer chosen to fit beside the f32 weights (mixtral: 19 GB).
# Each cell's f32 (rtol, atol): another order of the same sums. moonshot's
# shards own whole experts (read 2.38e-7 on an H100 80GB HBM3); mixtral's
# split adds two halves of a 16,384-term d_ff sum (read 1.94e-5 there).
MOE_CELLS = (("moonshot-v1-16b-a3b", 2048, (1e-6, 1e-6)),
             ("mixtral-8x22b", 512, (1e-5, 1e-4)))
MOE_V = 16
# (e) llama3.2-3b's prefill attention (batch, length) split over 16 model ranks
SPLIT_FLASH = (4, 4096, 16)
MESH_LOSS_RTOL = 1e-5                     # (d) f32, one-rank mesh against ctx=None
MESH_LEAF_RTOL = 1e-5                     # relative L2 per gradient / param leaf


def _dryrun_worker(out_dir: str, mesh: str) -> int:
    """``chip_smoke.py --dryrun-cells DIR MESH``: record each of DRYRUN_CELLS
    on MESH (``launch.dryrun.run_cell`` on a fake world of 256 or 512
    ranks) and write its record; extract each of DRYRUN_MAP_CELLS' per-rank
    graph and map it on the CPU under ell and xla pinned (the card's twin
    runs in phase 14 (b))."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    from repro_torch.configs.registry import SHAPES
    from repro_torch.core.api import SharedMapConfig, shared_map_direct
    from repro_torch.launch import dryrun
    from repro_torch.launch import fx_analysis as FX
    from repro_torch.launch.comm_graph import extract_fx_graph
    from repro_torch.launch.mesh import physical_hierarchy, stop_world
    torch.set_num_threads(2)    # beside the smoke's main process and the export worker
    failed = 0
    for arch, shape, mesh_ in DRYRUN_CELLS:
        if mesh_ != mesh:
            continue
        cell = next(c for c in SHAPES if c.name == shape)
        t0 = time.perf_counter()
        try:
            rec = dryrun.run_cell(arch, cell, multi_pod=mesh == "pod2", keep_graph=True)
        except Exception as e:   # the next cell still runs; the smoke fails on it
            import traceback
            print(f"dryrun worker: {arch} x {shape} failed: {e!r}\n"
                  f"{traceback.format_exc()[-3000:]}", flush=True)
            failed += 1
            continue
        rec["seconds"] = time.perf_counter() - t0
        graph = rec.pop("_graph")
        rec["largest_all_gather"] = max((FX.collective_bytes(n) for n in graph.nodes
                                         if FX.collective_kind(n) == "all-gather"), default=0)
        products = {}
        for n in graph.nodes:
            f = FX.node_flops(n) * FX.node_trips(n) if FX.is_task(n) else 0
            if f:
                key = f"{FX._op_name(n)} " + " x ".join(
                    str(list(FX._shape(i))) for i in FX.input_nodes(n)[:2])
                products[key] = products.get(key, 0) + f
        rec["top_products"] = sorted(products.items(), key=lambda kv: -kv[1])[:DRYRUN_TOP]
        if (arch, shape, mesh) in DRYRUN_MAP_CELLS:
            t0 = time.perf_counter()
            tg = extract_fx_graph(graph, min_tasks=2 * physical_hierarchy(False).k)
            rec["extract_s"] = time.perf_counter() - t0
            arrays = {"u": tg.u, "v": tg.v, "w": tg.w, "vwgt": tg.vwgt}
            h = physical_hierarchy(False)
            for backend in ("ell", "xla"):
                t0 = time.perf_counter()
                r = shared_map_direct(tg, h, SharedMapConfig(preset="fast", backend=backend),
                                      device="cpu")
                rec[f"cpu_{backend}_s"] = time.perf_counter() - t0
                rec[f"cpu_{backend}_J"] = r.J
                arrays[f"pe_{backend}"] = np.asarray(r.pe_of)
            np.savez(Path(out_dir) / f"{arch}__{shape}__{mesh}.npz", **arrays)
            rec["graph"] = {"n": tg.n, "m": tg.m, "meta": tg.meta,
                            "fingerprint": tg.fingerprint().hex()}
        del graph
        (Path(out_dir) / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(rec))
        print(f"dryrun worker: {arch} x {shape} x {mesh} in {rec['seconds']:.1f} s", flush=True)
    stop_world()
    return 1 if failed else 0


def _start_dryrun(out_dir: str) -> list:
    """Start the dry-run workers, one a mesh (no card: CUDA hidden from
    them)."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dryrun-cells",
                              out_dir, mesh], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for mesh in sorted({c[2] for c in DRYRUN_CELLS})]


def _dryrun_records(dev, _build, workers, out_dir: str) -> None:
    """Phase 14 (a) and (b): the workers' records beside the reference's
    fixtures; llama's and xlstm's per-rank graphs mapped on 16:16, fast,
    under ell and xla on the card, pe_of equal to the worker's CPU runs, J
    against the default placement."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import SharedMapConfig, shared_map_direct
    from repro_torch.core.mapping import evaluate_J
    from repro_torch.core.taskgraph import TaskGraph
    from repro_torch.launch.comm_graph import default_placement
    from repro_torch.launch.mesh import physical_hierarchy

    t0 = time.perf_counter()
    for worker in workers:
        log, _ = worker.communicate(timeout=900)
        if worker.returncode != 0:
            raise AssertionError(f"dry-run worker exited {worker.returncode}: {log[-3000:]}")
    print(f"dry-run workers: waited {time.perf_counter() - t0:.2f} s for them here", flush=True)
    ratios = json.loads(DRYRUN_FLOPS_RATIO.read_text())
    for arch, shape, mesh in DRYRUN_CELLS:
        rec = json.loads((Path(out_dir) / f"{arch}__{shape}__{mesh}.json").read_text())
        h_, mem = rec["hlo"], rec["memory"]
        fx = DRYRUN_FIXTURES / f"{arch.replace('.', '_')}__{shape}__{mesh}.json"
        ref = json.loads(fx.read_text()) if fx.exists() else None
        line = (f"dry-run {arch} x {shape} x {mesh} ({rec['chips']} fake ranks, host): "
                f"{rec['seconds']:.1f} s "
                f"(record {rec['lower_s']} s, {h_['graph_nodes']} nodes); argument bytes "
                f"{mem['argument_bytes']}, output {mem['output_bytes']}, alias "
                f"{mem['alias_bytes']}, peak live {mem['temp_bytes']}; FLOPs/device "
                f"{h_['flops_per_device']!r}; while_trips {h_['while_trips']}; collectives "
                f"{h_['num_collectives']} bytes "
                f"{h_['collective_bytes']}, the largest all-gather {rec['largest_all_gather']}; "
                f"roofline {rec['roofline']}")
        if rec["mode"] == "decode":
            # no all-gather moves one layer's cache shard (k or v)
            layer = mem["alias_bytes"] // (2 * get_config(arch).num_layers)
            if rec["largest_all_gather"] >= layer:
                raise AssertionError(f"dry-run {arch} x {shape}: an all-gather of "
                                     f"{rec['largest_all_gather']} bytes, a layer's cache "
                                     f"shard {layer}")
        if not 0 < rec["useful_ratio"] <= 1.0:
            raise AssertionError(f"dry-run {arch} x {shape}: useful_ratio "
                                 f"{rec['useful_ratio']!r}")
        line += f"; useful_ratio {rec['useful_ratio']:.4f}"
        if ref is not None:
            if mem["argument_bytes"] != ref["memory"]["argument_bytes"]:
                raise AssertionError(f"dry-run {arch}: argument bytes {mem['argument_bytes']}, "
                                     f"the reference's {ref['memory']['argument_bytes']}")
            ratio = h_["flops_per_device"] / ref["hlo"]["flops_per_device"]
            want = ratios["ratio"][f"{arch} x {shape} x {mesh}"]
            if abs(ratio / want - 1) > ratios["within"]:
                raise AssertionError(f"dry-run {arch} x {shape}: FLOPs/device ratio {ratio!r}, "
                                     f"measured {want!r} (within {ratios['within']})")
            line += (f"; the reference's argument bytes equal; FLOPs/device ratio "
                     f"{ratio:.4f} (held within {ratios['within']:.0%} of {want:.4f}), "
                     f"collective bytes ratio "
                     f"{h_['collective_total'] / ref['hlo']['collective_total']:.4f}")
        print(line, flush=True)
        total = h_["flops_per_device"]
        print(f"dry-run {arch} x {shape}: the {DRYRUN_TOP} largest products (FLOPs/device, "
              f"share): " + "; ".join(f"{k} {f:.4g} ({f / total:.1%})"
                                      for k, f in rec["top_products"]), flush=True)
        if "graph" not in rec:
            continue
        gi = rec["graph"]
        with np.load(Path(out_dir) / f"{arch}__{shape}__{mesh}.npz") as a:
            arrays = dict(a)
        tg = TaskGraph.from_edges(gi["n"], arrays["u"], arrays["v"], arrays["w"],
                                  vwgt=arrays["vwgt"], meta=gi["meta"])
        if tg.fingerprint().hex() != gi["fingerprint"]:
            raise AssertionError(f"dry-run {arch}: the graph changed on its way from the worker")
        h = physical_hierarchy(False)
        gt = tg.to_graph(device=dev)
        j_def = evaluate_J(gt, h, default_placement(tg.n, h.k), device=dev)
        no_lp = [k for k in MAPPING_KERNELS if k != "lp_gain"]
        parts = []
        for backend, expect in (("ell", MAPPING_KERNELS), ("xla", no_lp)):
            cfg = SharedMapConfig(preset="fast", backend=backend)
            r, sec, ln = _run_path(f"dry-run {arch} {backend}",
                                   lambda: shared_map_direct(tg, h, cfg, device=dev),
                                   expect, _build)
            cpu = arrays[f"pe_{backend}"]
            if r.pe_of.dtype != cpu.dtype or not np.array_equal(r.pe_of, cpu):
                raise AssertionError(f"dry-run {arch} {backend}: the card's pe_of differs from "
                                     f"the CPU's (J {r.J!r} / {rec[f'cpu_{backend}_J']!r})")
            parts.append(f"{backend}: card {sec:.2f} s (CPU {rec[f'cpu_{backend}_s']:.1f} s in "
                         f"the worker), J {r.J!r}, J/J_default {r.J / j_def:.4f}, pe_of equal "
                         f"to the CPU's, launches {ln}")
        print(f"dry-run {arch} x {shape} per-rank graph: {tg.n} tasks, {tg.m} edges "
              f"({tg.meta['granularity']}), extraction {rec['extract_s']:.2f} s; on {h} "
              f"k={h.k}, fast; J_default {j_def!r}; " + "; ".join(parts), flush=True)


def _moe_whole(cfg, p: dict, V: int) -> dict:
    """The V shards' expert weights laid out for V = 1 (shard v's experts are
    v * E_loc..; expert e's d_ff shards are virtual shards e * V/E.. in order)."""
    import torch
    E = cfg.num_experts
    if E >= V:
        return {k: p[k].reshape((1, E) + tuple(p[k].shape[2:])) for k in ("w_gate", "w_up",
                                                                         "w_down")}
    r = V // E
    return {"w_gate": torch.cat([p["w_gate"][j::r, 0] for j in range(r)], -1)[None],
            "w_up": torch.cat([p["w_up"][j::r, 0] for j in range(r)], -1)[None],
            "w_down": torch.cat([p["w_down"][j::r, 0] for j in range(r)], -2)[None]}


def _moe_parallel(dev) -> None:
    """Phase 14 (c): one MoE layer of each of MOE_CELLS at full width, its
    MOE_V virtual shards run one after another on the card (NCCL puts one
    rank on a card) and summed in shard order, against V = 1 on the same
    weights: f32 within the cell's limits, bf16 within the logits
    tolerances. A wrong layout must fail the f32 limits: the shards rotated
    (shard v routes its own experts' tokens through shard v+1's weights)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as MoE
    for arch, T, f32_tol in MOE_CELLS:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        assert MoE.capacity(cfg, T) == T
        E_loc, F_v = MoE.moe_layout(cfg, MOE_V)
        g = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            p = {k: w.data for k, w in MoE.moe_params(cfg, g, device=dev, V=MOE_V).items()}
            whole = _moe_whole(cfg, p, MOE_V)
            x = torch.randn(T, cfg.d_model, generator=g, device=dev)
            notes = []
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                total = torch.zeros_like(xd)
                for virt in range(MOE_V):
                    total = total + MoE.moe_ffn_shard(cfg, xd, p["router"], p["w_gate"][virt],
                                                      p["w_up"][virt], p["w_down"][virt],
                                                      virt, MOE_V)
                torch.cuda.synchronize()
                t_sh = time.perf_counter() - t0
                t0 = time.perf_counter()
                one = MoE.moe_ffn_shard(cfg, xd, p["router"], whole["w_gate"][0],
                                        whole["w_up"][0], whole["w_down"][0])
                torch.cuda.synchronize()
                t_one = time.perf_counter() - t0
                rtol, atol = f32_tol if dtype == torch.float32 else (LOGITS_RTOL, LOGITS_ATOL)
                diff = float((total.float() - one.float()).abs().max())
                if not torch.allclose(total.float(), one.float(), rtol=rtol, atol=atol):
                    raise AssertionError(f"MoE {arch} {dtype}: the {MOE_V} shards' sum differs "
                                         f"from V = 1 by {diff} (rtol {rtol}, atol {atol})")
                notes.append(f"{str(dtype)[6:]}: max abs diff {diff:.3g} of outputs up to "
                             f"{float(one.float().abs().max()):.3g} (rtol {rtol}, atol {atol}), "
                             f"shards {t_sh * 1e3:.1f} ms, whole {t_one * 1e3:.1f} ms")
                if dtype != torch.float32:
                    continue
                wrong = torch.zeros_like(xd)
                for virt in range(MOE_V):
                    w = (virt + 1) % MOE_V
                    wrong = wrong + MoE.moe_ffn_shard(cfg, xd, p["router"], p["w_gate"][w],
                                                      p["w_up"][w], p["w_down"][w], virt, MOE_V)
                bad = float((wrong - one).abs().max())
                if torch.allclose(wrong, one, rtol=rtol, atol=atol):
                    raise AssertionError(f"MoE {arch}: the rotated layout passes the f32 limits")
                notes.append(f"the shards rotated read {bad:.3g}")
                del wrong
        print(f"MoE {arch} at full width (E {cfg.num_experts}, top-{cfg.top_k}, d_model "
              f"{cfg.d_model}, d_ff {cfg.d_ff}), {T} tokens: V = {MOE_V} (E_loc {E_loc}, F_v "
              f"{F_v}) summed in shard order against V = 1; " + "; ".join(notes), flush=True)
        del p, whole, x, total, one
        torch.cuda.empty_cache()


def _mesh_one_rank(dev, _build) -> None:
    """Phase 14 (d): a one-rank NCCL world and its ("data", "model") mesh.
    llama3.2-3b's smoke prefill through flash (each rank's local q/k/v) and
    one f32 train step under the mesh ctx, against ctx=None."""
    import copy
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as MM
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, loss_and_grads, make_train_step

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=dev if dev.index is not None
                            else torch.device("cuda", 0))
    try:
        mesh = DeviceMesh("cuda", torch.tensor([[0]]), mesh_dim_names=("data", "model"))
        cfg = get_smoke_config(ARCH)
        params = MM.init_fn(cfg, torch.Generator(device=dev).manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 300)),
                               device=dev)
        want = MM.prefill_fn(cfg, params, {"tokens": toks}, ShardCtx(use_flash=True))
        mparams = SH.shard_params(copy.deepcopy(params), mesh)
        ctx = ShardCtx(mesh=mesh, use_flash=True)
        batch = {"tokens": toks}
        batch = SH.place_tree(batch, SH.batch_specs(cfg, batch, ctx), mesh)
        got, sec, ln = _run_path("mesh prefill", lambda: MM.prefill_fn(cfg, mparams, batch, ctx),
                                 ["flash_attention"], _build)
        got = got.full_tensor()
        diff = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=LOGITS_ATOL, rtol=LOGITS_RTOL):
            raise AssertionError(f"mesh prefill: differs from ctx=None by {diff}")
        print(f"one-rank NCCL mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {cfg.name} "
              f"prefill B=2 S=300 through flash on the local q/k/v: {sec * 1e3:.1f} ms, flash "
              f"launches {ln['flash_attention']}, logits against ctx=None: "
              f"{'bitwise equal' if torch.equal(got, want) else f'max abs diff {diff:.4g}'} "
              f"(held within atol {LOGITS_ATOL} rtol {LOGITS_RTOL})", flush=True)

        _f32_compute(True)
        try:
            rng = np.random.default_rng(2)
            b = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)), device=dev)
                 for k in ("tokens", "labels")}
            one = init_train_state(cfg, torch.Generator(device=dev).manual_seed(3))
            sharded = SH.shard_state(init_train_state(
                cfg, torch.Generator(device=dev).manual_seed(3)), mesh)
            mctx = ShardCtx(mesh=mesh)
            bd = SH.place_tree(b, SH.batch_specs(cfg, b, mctx), mesh)
            loss, grads = loss_and_grads(cfg, one.params, b)
            mloss, mgrads = loss_and_grads(cfg, sharded.params, bd, mctx)
            worst = 0.0
            for k, gw in grads.items():
                m = mgrads[k].full_tensor()
                worst = max(worst, float((m - gw).norm() / gw.norm().clamp_min(1e-30)))
            mloss = float(mloss.full_tensor())
            if abs(mloss - float(loss)) > MESH_LOSS_RTOL * abs(float(loss)) or \
                    worst > MESH_LEAF_RTOL:
                raise AssertionError(f"mesh train step: loss {mloss!r} / {float(loss)!r}, worst "
                                     f"gradient leaf relative L2 {worst}")
            step = make_train_step(cfg, AdamWConfig())
            mstep = make_train_step(cfg, AdamWConfig(), mctx)
            one, _ = step(one, b)
            sharded, _ = mstep(sharded, bd)
            worst_p = max(float((w2.full_tensor() - w1).detach().norm()
                                / w1.detach().norm().clamp_min(1e-30))
                          for (_, w1), (_, w2) in zip(one.params.named_parameters(),
                                                      sharded.params.named_parameters()))
            if worst_p > MESH_LEAF_RTOL:
                raise AssertionError(f"mesh train step: params after it apart by {worst_p}")
            print(f"one-rank NCCL mesh: {cfg.name} f32 train step B=2 S=64 under the mesh ctx "
                  f"against ctx=None: loss {mloss!r} / {float(loss)!r}, worst gradient leaf "
                  f"relative L2 {worst:.3g}, params after the AdamW step {worst_p:.3g} "
                  f"(held within loss rtol {MESH_LOSS_RTOL}, leaf {MESH_LEAF_RTOL})", flush=True)
        finally:
            _f32_compute(False)
    finally:
        dist.destroy_process_group()


def _split_flash(dev, _build) -> None:
    """Phase 14 (e): one layer of llama3.2-3b's prefill attention at full
    width (bf16, B x S and the model ranks of SPLIT_FLASH), split as the
    model ranks of a mesh split it: each rank's ``attention._rank_share``
    (its column shards of the projections moved by its all-to-all plan to
    its (batch row, kv group) units, RoPE, flash on the units, and back),
    every rank in lock-step on this card (``attention.ranks_in_turn``, the
    all-to-all done by hand). The column shards put back together must
    equal one flash call on the whole layer bit for bit."""
    import functools

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.layers import apply_rope, rope_angles
    cfg = get_config(ARCH)
    B, S, M = SPLIT_FLASH
    G, Dh = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(B, S, n * Dh, generator=g, device=dev).to(torch.bfloat16)
               for n in (cfg.num_heads, G, G))
    rope = rope_angles(torch.arange(S, device=dev)[None, :], Dh, cfg.rope_theta)
    attend = functools.partial(A._flash, cfg, True)

    def whole():
        qh, kh, vh = (t.reshape(B, S, -1, Dh) for t in (q, k, v))
        return attend(apply_rope(qh, *rope), apply_rope(kh, *rope), vh).reshape(B, S, -1)

    def split():
        def cols(t, m):
            return t[:, :, slice(*A._chunk_range(t.shape[2], M, m))]
        return torch.cat(A.ranks_in_turn([
            A._rank_share(cfg, attend, cols(q, m), cols(k, m), cols(v, m), kinds=("cols",) * 3,
                          rope=rope, M=M, m=m) for m in range(M)]), dim=2)

    want, t_whole, _ = _run_path("split flash: whole", whole, ["flash_attention"], _build)
    got, t_split, ln = _run_path("split flash: shares", split, ["flash_attention"], _build)
    if not torch.equal(got, want):
        raise AssertionError(f"split flash: the {M} shares differ from the whole call by "
                             f"{float((got.float() - want.float()).abs().max())}")
    print(f"split flash: {ARCH} layer attention B={B} S={S} bf16 (heads {cfg.num_heads}/"
          f"{G}), {B * G} (batch row, kv group) units over {M} model ranks, each rank's "
          f"_rank_share in turn: the shares put back together equal the whole flash call bit "
          f"for bit; whole {t_whole * 1e3:.1f} ms, shares one after another "
          f"{t_split * 1e3:.1f} ms (flash launches {ln['flash_attention']}, the layout moves "
          f"on this card)", flush=True)


def _launch_path(dev, _build, workers, out_dir: str) -> None:
    """Phase 14: the multi-device launch/ pieces (see the module doc). (c)
    and (d) run first, so the worker has the longest; each part runs even
    when one before it failed, and the phase then raises the first error."""
    import traceback

    import torch
    t0 = time.perf_counter()
    parts = (("(c)", lambda: _moe_parallel(dev)), ("(d)", lambda: _mesh_one_rank(dev, _build)),
             ("(e)", lambda: _split_flash(dev, _build)),
             ("(a)+(b)", lambda: _dryrun_records(dev, _build, workers, out_dir)))
    errors, took = [], []
    for name, part in parts:
        t = time.perf_counter()
        try:
            part()
        except Exception as e:
            errors.append(e)
            print(f"phase 14 {name} FAILED: {e!r}\n{traceback.format_exc()[-4000:]}",
                  flush=True)
        torch.cuda.empty_cache()
        took.append(f"{name} {time.perf_counter() - t:.1f} s")
    if errors:
        raise errors[0]
    print(f"phase 14: {time.perf_counter() - t0:.1f} s in all ({', '.join(took)})", flush=True)


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
    from repro_torch.core.taskgraph import TaskGraph
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.coarsen_kernels import hem_propose_cuda
    from repro_torch.kernels.powf import near_midpoint, powf_cuda, powf_ref
    from repro_torch.kernels.split import gather_rows_cuda

    t_start = time.perf_counter()   # each phase prints when it starts
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
    export_dir = tempfile.TemporaryDirectory()   # phase 9 (d)'s graphs, made meanwhile
    exports = _start_exports(export_dir.name)
    atexit.register(exports.kill)   # nothing once it has ended
    dryrun_dir = tempfile.TemporaryDirectory()   # phase 14 (a)'s records, made meanwhile
    dryruns = _start_dryrun(dryrun_dir.name)
    for worker in dryruns:
        atexit.register(worker.kill)
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
    print(f"phase 2 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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
    print(f"phase 3 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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
            print(f"small {name} float weights backend {backend}: two card runs give one "
                  f"pe_of and J {a.J!r}; card against CPU: pe_of equal on {same} of "
                  f"{len(a.pe_of)} vertices, J {a.J!r} / {b.J!r}", flush=True)

    # ---- 4. the other strategies on the card, at rgg 2^15 ------------------
    print(f"phase 4 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    gsm = G.gen_rgg(RGG_N_STRATEGIES, seed=0, device=dev)
    every = list(MAPPING_KERNELS)
    strat = {}

    host_split = [k for k in every if k != "gather_rows"]   # split on the host

    hs = parse_hierarchy(*STRATEGY_HIERARCHY)

    def run_strategy(label, cfg, resident=None, expect=every, backend="ell", hh=hs):
        def go():
            MS.reset_transfer_stats()
            res = shared_map_direct(gsm, hh, cfg, resident=resident, device=dev)
            return res, MS.transfer_stats()
        (res, xfer), sec, launches = _run_path(label, go, expect, _build)
        if res.stats["backend"] != backend:
            raise AssertionError(f"{label}: backend {res.stats['backend']!r}")
        strat[label] = res
        print(f"strategy {label} rgg n={RGG_N_STRATEGIES} on {hh}: {sec:.2f} s, "
              f"J {res.J}, partition calls {res.stats['partition_calls']}, array "
              f"fetches {xfer['d2h_array_fetches']}, launches {launches}", flush=True)
        return xfer
    run_strategy("bucket", SharedMapConfig())
    run_strategy("bucket, xla pinned", SharedMapConfig(backend="xla"),
                 expect=[k for k in every if k != "lp_gain"], backend="xla")
    # the device strategy and its twin on three levels, as the main path
    xfer = run_strategy("device", SharedMapConfig(strategy="device"), hh=h)
    if xfer["d2h_array_fetches"] != 1:
        raise AssertionError(f"device strategy fetched {xfer['d2h_array_fetches']} arrays")
    run_strategy("device resident=False", SharedMapConfig(strategy="device"), False,
                 host_split, hh=h)
    if not np.array_equal(strat["device"].pe_of, strat["device resident=False"].pe_of):
        raise AssertionError("device strategy differs from its resident=False twin")
    run_strategy("layer", SharedMapConfig(strategy="layer"))
    run_strategy("naive", SharedMapConfig(strategy="naive"), expect=host_split)
    if not np.array_equal(strat["bucket"].pe_of, strat["naive"].pe_of):
        raise AssertionError("bucket strategy differs from naive")
    run_strategy("queue", SharedMapConfig(strategy="queue"), expect=host_split)
    if not np.array_equal(strat["queue"].pe_of, strat["naive"].pe_of):
        raise AssertionError("queue strategy differs from naive")
    run_strategy("bucket, xla pinned, second run", SharedMapConfig(backend="xla"),
                 expect=[k for k in every if k != "lp_gain"], backend="xla")
    if not np.array_equal(strat["bucket, xla pinned"].pe_of,
                          strat["bucket, xla pinned, second run"].pe_of):
        raise AssertionError("two runs of one path gave different pe_of")
    print(f"strategies: device equals its twin with one array fetch on {h}; on {hs} naive "
          f"equals bucket, queue equals naive, two xla runs give one pe_of", flush=True)
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
        MS.reset_transfer_stats()
        a, _, ln = _run_path(f"device strategy {name} on {deep_h}",
                             lambda: shared_map_direct(gs, deep_h, deep_cfg, device=dev),
                             ["powf"], _build)
        fetches = MS.transfer_stats()["d2h_array_fetches"]
        if fetches != 1:
            raise AssertionError(f"device strategy on {deep_h} fetched {fetches} arrays")
        b = shared_map_direct(gs, deep_h, deep_cfg, device="cpu")
        if not np.array_equal(a.pe_of, b.pe_of):
            raise AssertionError(f"device strategy, {name} on {deep_h}: the card's pe_of "
                                 "differs from the CPU's")
        H._powf = torch_powf
        try:
            old = shared_map_direct(gs, deep_h, deep_cfg, device=dev)
        finally:
            H._powf = pow_powf
        print(f"device strategy {name} on {deep_h}: pe_of equal on card and CPU, one "
              f"array fetch, {ln['powf']} powf launches, J {a.J} / {b.J}; with torch's pow (the "
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
    print(f"phase 5 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # Device time and op counts come from the CUDA-side events alone (kernels,
    # copies, sets): an aten op's own entry repeats the time of the kernels
    # it launched. A first, tiny profile takes the tracer's start-up cost.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    for backend, deg in (("ell", deg_root), ("xla", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            partition(gp, top, 0.03, lv, "eco", 0, backend, deg, device=dev)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events)
        print(f"profile: root partition call (N={N0}, M={M0}, k={top}, {lv} levels, "
              f"eco, {backend}, cap {deg}): wall {wall:.2f} s under the profiler, device "
              f"busy {busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}%), "
              f"{sum(e.count for e in events)} device ops", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"profile:   {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
                  f"{e.key[:90]}", flush=True)
        del prof, events

    # ---- 6. the main path at a real size, and xla pinned, in turns ---------
    print(f"phase 6 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # The second ell run takes the graph as a TaskGraph: its canonical CSR
    # holds the same edges as gen_rgg's, each row's neighbours in another
    # order, so its pe_of is compared with the fourth run's, on that CSR as
    # a Graph.
    t0 = time.perf_counter()
    tg = TaskGraph.from_graph(g)
    t_from = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gt = tg.to_graph(device=dev)
    torch.cuda.synchronize()
    t_to = time.perf_counter() - t0
    differ = [f for f, a, b in zip(G.Graph._fields, g, gt) if not torch.equal(a, b)]
    print(f"TaskGraph of rgg n={n}: {tg.m} undirected edges, fingerprint "
          f"{tg.fingerprint().hex()}, from_graph {t_from:.3f} s, to_graph on the card "
          f"{t_to:.3f} s; fields of its CSR that differ from gen_rgg's: {differ}",
          flush=True)

    def main_path(cfg, graph=g):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = shared_map(graph, h, cfg, device=dev)
        return out, torch.cuda.max_memory_allocated()
    no_lp = [k for k in every if k != "lp_gain"]
    dispatches = {}   # every batched_partition call of a run, to keep its widest
    saved_bp = _capture(MS, "batched_partition", dispatches.setdefault("ell", []))
    try:
        (res, peak), t_first, launches = _run_path(
            "main path", lambda: main_path(SharedMapConfig()), every, _build)
    finally:
        MS.batched_partition = saved_bp
    (res_x, peak_x), t_xla, launches_x = _run_path(
        "xla pinned", lambda: main_path(SharedMapConfig(backend="xla")), no_lp, _build)
    (res2, _), t_second, _ = _run_path(
        "main path, second run, fed the TaskGraph", lambda: main_path(SharedMapConfig(), tg),
        every, _build)
    pe = res.pe_of
    rng = np.random.default_rng(0)
    j_rand = evaluate_J(g, h, rng.integers(0, h.k, n).astype(np.int32), device=dev)
    wv = g.vwgt[:n].cpu().numpy()
    for label, r, secs, pk, ln in (
            ("main path", res, f"{t_first:.2f} s, fed the TaskGraph {t_second:.2f} s",
             peak, launches),
            ("xla pinned", res_x, f"{t_xla:.2f} s", peak_x, launches_x)):
        bw = np.bincount(r.pe_of, weights=wv, minlength=h.k)
        print(f"{label} rgg n={n} on {h}: {secs}, backend "
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
    for r in (res, res2, res_x):
        if not r.J < j_rand:
            raise AssertionError(f"J {r.J} not below the random mapping's {j_rand}")
    print(f"main path: the TaskGraph's run J {res2.J} against gen_rgg's Graph's {res.J}, "
          f"pe_of equal on {int((res2.pe_of == pe).sum())} of {n} vertices", flush=True)
    if res.J != MAIN_PATH_J or res_x.J != MAIN_PATH_J_XLA:
        raise AssertionError(f"main path J {res.J} (ell) / {res_x.J} (xla), expected "
                             f"{MAIN_PATH_J} / {MAIN_PATH_J_XLA}")
    # the widest level: one batched v-cycle for its lanes (the reference's vmap)
    wide = [x["seconds"] for x in res.stats["levels"]], [x["seconds"] for x in
                                                         res_x.stats["levels"]]
    print(f"main path {res.stats['levels'][-1]['graphs']}-graph level: ell {wide[0][-1]:.2f} s "
          f"of {t_first:.2f} s, xla {wide[1][-1]:.2f} s of {t_xla:.2f} s; peak memory ell "
          f"{peak / 1e9:.2f} GB, xla {peak_x / 1e9:.2f} GB", flush=True)
    _widest_dispatch(max(dispatches.pop("ell"), key=lambda a: len(a[3])), _build)

    # every launch of the mapping kernels timed, in a fourth run under ell, on
    # the TaskGraph's CSR as a Graph; contract_edges and lp_gain held and
    # timed at the captured shapes
    (out_t, times, caps), t_timed, launches_t = _run_path(
        "main path, every launch timed",
        lambda: _timed_main_path(lambda: main_path(SharedMapConfig(), gt), kops), every,
        _build)
    if not np.array_equal(out_t[0].pe_of, res2.pe_of):
        raise AssertionError("shared_map of the TaskGraph and of its Graph gave other pe_of")
    by_n = {}   # by (lanes, padded size), the largest size first

    def by_size(keys):
        return sorted(keys, key=lambda key: (-key[1], -key[0]))
    for name in MAPPING_KERNELS:
        per = times.get(name, {})
        if sum(map(len, per.values())) != launches_t[name]:
            raise AssertionError(f"{name}: {sum(map(len, per.values()))} timed calls, "
                                 f"{launches_t[name]} launches")
        by_n[name] = {_key_str(n): {"launches": len(per[n]), "ms": sum(per[n]),
                                    "ms_per_launch": statistics.median(per[n])}
                      for n in by_size(per)}
        print(f"main path, every launch timed: {name} {launches_t[name]} launches, "
              f"{sum(map(sum, per.values())):.4f} ms in all; by lanes x padded size: "
              + "; ".join(f"{n}: {d['launches']} launches, {d['ms']:.4f} ms, median "
                          f"{d['ms_per_launch']:.5f} ms" for n, d in by_n[name].items()),
              flush=True)
    print(f"main path, every launch timed: {t_timed:.2f} s end to end (with the "
          f"events' host cost), on the TaskGraph's CSR as a Graph: pe_of equal to the "
          f"TaskGraph run's", flush=True)
    # each held bitwise and timed at every (lanes, padded size) of the run,
    # the batched levels' shapes included
    for name, case in (("contract_edges", _contract_case), ("lp_gain", _lp_gain_case)):
        keys = by_size(caps[name])
        for n in keys:   # the root's shape joins the line
            label, kernel, plain, args, nbytes, flops, lib = case(caps[name][n])
            row = check(name, kernel, plain, args, True, nbytes, flops, library=lib,
                        record=n == keys[0], label=f" at {label}")
            by_n[name][_key_str(n)].update(
                kernel_ms=row["ms"], device_ms=row["device_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                plain_ms=row["plain_ms"], library_ms=row["library_ms"])
    # hem_propose in rounds 1 and 3 of the first coarsening level at each
    # size (the line's row is phase 2's, the root's round 1)
    for n in by_size(caps["hem_propose"]):
        calls = caps["hem_propose"][n]
        for rnd in (1, 3):
            label, kernel, plain, args, nbytes, flops, _ = _hem_case(calls[rnd - 1])
            row = check("hem_propose", kernel, plain, args, True, nbytes, flops,
                        record=False, label=f" round {rnd} at {label}")
            by_n["hem_propose"][_key_str(n)][f"round{rnd}"] = {
                k: row[k] for k in ("ms", "device_ms", "bound_ms", "bound_by", "plain_ms")}
    # mapcost on the main path's own final pe_of
    (m_args,) = caps["mapcost"].values()
    label, kernel, plain, args, nbytes, flops, _ = _mapcost_case(m_args)
    mapcost_main = check("mapcost", kernel, plain, args, False, nbytes, flops, rtol=1e-5,
                         record=False, label=f" at the main path's pe_of, {label}")
    if float(kernel(*args)) != out_t[0].J:
        raise AssertionError("mapcost at the main path's pe_of gives another J")
    pe_main, j_main = res.pe_of, res.J
    del gp, res, res_x, out_t, times, caps, m_args, args
    torch.cuda.empty_cache()

    # ---- 7. the paper's quality comparison ---------------------------------
    print(f"phase 7 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    _quality_small(dev)
    _quality_main(dev, g, tg, gt, h, res2, t_second, every, _build)
    del gt, tg, res2
    torch.cuda.empty_cache()

    # ---- 8. the mapping service on the card ----------------------------------
    print(f"phase 8 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    _service_path(dev, g, h, pe_main, j_main, _build)
    torch.cuda.empty_cache()

    # ---- 9. HLO ingestion, the closed loop, the segment path, the cascade ----
    print(f"phase 9 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    _ingestion_path(dev, g, deg_root, _build)
    del g
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _export_path(dev, _build, exports, export_dir.name)
    print(f"phase 9 (d): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 10. the serving path: llama3.2-3b at full width --------------------
    print(f"phase 10 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    flash_launches = _serving_path(dev, check, _build)
    torch.cuda.empty_cache()

    # ---- 11. the rest of the model zoo ---------------------------------------
    print(f"phase 11 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    zoo_launches, zoo_errs = _zoo_path(dev, _build)

    # ---- 12. training ---------------------------------------------------------
    print(f"phase 12 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    torch.cuda.empty_cache()
    _train_path(dev)

    # ---- 14. the multi-device launch/ pieces ----------------------------------
    print(f"phase 14 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    torch.cuda.empty_cache()
    _launch_path(dev, _build, dryruns, dryrun_dir.name)

    # ---- 13. the kernels line and the contract's last line ------------------
    print(f"phase 13 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    for r in rows:
        if r["name"] == "flash_attention":
            r["launches"] = flash_launches
            r["launches_by_path"] = {f"{ARCH} prefill": flash_launches, **zoo_launches}
            r["max_abs_err_by_path"] = {f"{ARCH} prefill": r["max_abs_err"], **zoo_errs}
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
    if sys.argv[1:2] == ["--export-cells"]:
        sys.exit(_export_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--dryrun-cells"]:
        sys.exit(_dryrun_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
