"""Multi-pod dry-run: trace one rank's step of every (arch x shape x mesh)
cell on a fake world of 256 or 512 ranks (the port of
``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny \\
        --shape train_4k --mesh pod1 --map      # + SharedMap placement on the card
    ... --map --device cpu                       # the mapping on the CPU

Writes one JSON line per cell (incremental: a rerun skips the cells done).

Where the reference forces 512 host devices before JAX starts and lowers
and compiles the SPMD program, the port starts torch's fake process group
(``launch.mesh.start_fake_world``) of the mesh's size, builds the
production ``DeviceMesh`` on it, places meta DTensors (params, moments,
batch, cache) by ``launch/shardings.py`` and runs ONE rank's step eagerly
on them, recording its local ATen ops plus ``_c10d_functional``
collectives (``fx_analysis.LocalRecorder``). Nothing is allocated and no
device is touched; the fake group's collectives move no data, so the
record gives shapes, bytes and counts, never a value.

The record has the reference's keys:

* ``memory``: ``argument_bytes`` / ``output_bytes``, exact from the local
  shards of the step's inputs and results; ``alias_bytes`` those updated
  in place (the train state, the decode cache); ``temp_bytes`` the peak of
  the bytes the traced ops' results hold live at once
  (``fx_analysis.peak_live_bytes``: every result lives from its op to its
  last use; not a compiler's buffer assignment), and ``per_device_total``
  as the reference sums them.
* ``cost_analysis`` / ``hlo``: per-rank FLOPs (``fx_analysis``), an HBM
  traffic estimate (each op's result written and read once, a matrix
  product's operands read), collective payload bytes and counts by kind.
  The layer loop is unrolled in the trace; the sLSTM's time scan is a
  loop region of the recorder (``LocalRecorder.scan``): three iterations
  recorded, the middle one scaled by its trips, backward included, and
  ``hlo.while_trips`` lists each region's trip count.
* ``roofline`` on the H100 SXM's peak rates (dense bf16 tensor cores, HBM3,
  NVLink per direction), and ``useful_ratio`` = model FLOPs / traced FLOPs.
* ``lower_s`` (the trace) and ``compile_s`` (reading the traced graph).
* ``map`` (``--map``): the traced graph as a communication ``TaskGraph``
  (``comm_graph.extract_fx_graph``), mapped by ``shared_map`` (preset
  ``fast``) onto ``mesh.physical_hierarchy`` on ``--device`` (the card by
  default) and scored against ``default_placement``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs.registry import ARCHS, SHAPES, cell_applicable, get_config
from ..models import model as M
from ..models.sharding import ShardCtx, is_dtensor
from ..train.optimizer import AdamWConfig, OptState
from ..train.train_step import TrainState, make_train_step, train_state
from . import fx_analysis as FX
from . import shardings as SH
from .mesh import make_production_mesh, start_fake_world, stop_world

# H100 SXM (per card): dense bf16 tensor-core peak, HBM3, NVLink per direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


def make_ctx(mesh, multi_pod: bool, global_batch: int | None = None, **knobs) -> ShardCtx:
    axes = ("pod", "data") if multi_pod else ("data",)
    if global_batch is not None:
        # tiny batches (long_500k has B=1) cannot shard over the batch axes;
        # drop axes until the product divides the batch.
        names = list(mesh.mesh_dim_names)
        while axes:
            prod = 1
            for a in axes:
                prod *= mesh.size(names.index(a))
            if global_batch % prod == 0:
                break
            axes = axes[1:]
    return ShardCtx(mesh=mesh, batch_axes=axes, model_axis="model", **knobs)


def ensure_fake_world(chips: int) -> None:
    """The default process group as a fake world of ``chips`` ranks (a
    group of another size or backend is replaced)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() == chips and dist.get_backend() == "fake":
            return
        stop_world()
    start_fake_world(chips)


def _local_bytes(tree) -> int:
    total = 0
    for _, t in SH.tree_paths(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _meta_params(cfg, V: int, dtype=None):
    from ..models.transformer import DecoderLM, set_param
    from ..models.whisper import EncDecLM
    params = EncDecLM(cfg, device="meta") if cfg.is_encoder_decoder else \
        DecoderLM(cfg, device="meta", V=V)
    if dtype is not None:   # serving checkpoints in bf16
        for name, w in list(params.named_parameters()):
            if w.dtype == torch.float32:
                set_param(params, name, torch.nn.Parameter(w.to(dtype), requires_grad=False))
    return params


def _reads_pos(cfg) -> bool:
    """Whether a decode step reads its position: an attention layer's cache
    slot, or whisper's positional embedding."""
    return cfg.is_encoder_decoder or any(k.split("+")[0] == "attn" for k in cfg.layer_kinds())


def _state_tree(state: TrainState) -> dict:
    return {"params": dict(state.params.named_parameters()), "mu": state.opt.mu,
            "nu": state.opt.nu, "step": state.opt.step}


def lower_cell(cfg, cell, mesh, ctx, serve_bf16: bool = False, scan_regions: bool = True):
    """Record one rank's step of ``cell``. Returns ``(graph, trip_hints,
    info)``; ``info`` holds ``argument_bytes``, ``output_bytes``,
    ``alias_bytes`` and ``while_trips`` (the trips of each loop region
    recorded; ``scan_regions=False`` records every iteration instead)."""
    V = ctx.model_size
    specs = M.input_specs(cfg, cell.seq_len, cell.global_batch, cell.mode)
    bspecs = SH.batch_specs(cfg, specs, ctx)
    batch = SH.place_tree(specs, bspecs, mesh, meta=True)
    keys = sorted(batch)
    wmode = ctx.weight_mode
    hints = M.scan_trip_hints(cfg, cell.seq_len, cell.mode, slstm_chunk=ctx.slstm_chunk)

    if cell.mode == "train":
        params = SH.shard_params(_meta_params(cfg, V), mesh, wmode, meta=True)
        state = train_state(params)
        # the step counter is read on the host (the schedule), so it is real
        state = state._replace(opt=OptState(torch.zeros((), dtype=torch.int32),
                                            state.opt.mu, state.opt.nu))
        step = make_train_step(cfg, AdamWConfig(), ctx)

        def run(b):
            _, metrics = step(state, b)
            return metrics
        alias = _local_bytes(_state_tree(state))
        args_bytes, dropped = alias, batch
    else:
        params = SH.shard_params(_meta_params(cfg, V, torch.bfloat16 if serve_bf16 else None),
                                 mesh, wmode, meta=True)
        if cell.mode == "prefill":
            def run(b):
                return M.prefill_fn(cfg, params, b, ctx)
            alias = args_bytes = 0
        else:   # decode: one token against a cache of cell.seq_len
            cache = M.init_cache(cfg, cell.global_batch, cell.seq_len, device="meta", V=V)
            cache = SH.place_tree(cache, SH.cache_specs(cfg, cache, ctx), mesh, meta=True)
            pos = cell.seq_len - 1

            def run(b):
                return M.decode_fn(cfg, params, b["tokens"], cache, pos, ctx)
            alias = _local_bytes(cache)
            # + pos, where the step reads it (jit drops it where no layer
            # attends: xLSTM's recurrent decode)
            args_bytes = alias + (4 if _reads_pos(cfg) else 0)
        dropped = {"params": dict(params.named_parameters()), "batch": batch}

    rec = FX.LocalRecorder(scan_regions=scan_regions)
    with rec:
        result = run(batch)
    graph = rec.finish(result)
    # of the batch and the serving params, only the leaves the step reads
    # (jit drops an unused argument: prefill's labels, whisper's decoder in
    # its prefill and its encoder in decode)
    read = {id(n.meta["val"]) for n in graph.nodes if n.op == "placeholder"}
    args_bytes += sum(_local_bytes(t) for _, t in SH.tree_paths(dropped)
                      if id(t._local_tensor if is_dtensor(t) else t) in read)
    # the results: the recorded outputs (metrics, logits) and what the step
    # updates in place (the train state, the decode cache)
    out = next(n for n in graph.nodes if n.op == "output")
    out_bytes = alias + sum(FX.node_bytes(n) for n in FX.input_nodes(out)
                            if n.op == "call_function" and not FX._writes_in_place(n))
    return graph, hints, {"argument_bytes": int(args_bytes), "output_bytes": int(out_bytes),
                          "alias_bytes": int(alias), "while_trips": rec.loops}


def hbm_bytes(graph) -> float:
    """Per-rank HBM traffic estimate: each task's result written and read
    once, a matrix product's operands read as well; each times its trips."""
    total = 0.0
    for n in graph.nodes:
        if not FX.is_task(n) or FX.collective_kind(n) is not None:
            continue
        if FX.node_flops(n):
            moved = sum(FX.node_bytes(i) for i in FX.input_nodes(n)) + FX.node_bytes(n)
        else:
            moved = 2 * FX.node_bytes(n)
        total += moved * FX.node_trips(n)
    return total


def run_cell(arch: str, cell, multi_pod: bool, knobs: dict | None = None,
             map_placement: bool = False, device=None, keep_graph: bool = False) -> dict:
    """The record of one cell (see the module docstring). ``device``: where
    ``--map`` maps (``None`` = the card). ``keep_graph`` adds the traced
    ``GraphModule`` under ``"_graph"`` (not JSON)."""
    cfg = get_config(arch)
    chips = 512 if multi_pod else 256
    ensure_fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    knobs = dict(knobs or {})
    serve_bf16 = knobs.pop("serve_bf16", False)
    ctx = make_ctx(mesh, multi_pod, global_batch=cell.global_batch, **knobs)
    rec = {
        "arch": arch, "shape": cell.name, "mesh": "pod2" if multi_pod else "pod1",
        "chips": chips, "mode": cell.mode,
        "knobs": {**knobs, **({"serve_bf16": True} if serve_bf16 else {})},
    }
    t0 = time.time()
    graph, hints, info = lower_cell(cfg, cell, mesh, ctx, serve_bf16=serve_bf16)
    rec["lower_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    flops = FX.total_flops(graph)
    coll_bytes, coll_count = FX.collective_totals(graph)
    hbm = hbm_bytes(graph)
    temp = FX.peak_live_bytes(graph)
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["memory"] = {
        "argument_bytes": info["argument_bytes"],
        "output_bytes": info["output_bytes"],
        "temp_bytes": int(temp),
        "alias_bytes": info["alias_bytes"],
        "per_device_total": int(info["argument_bytes"] + temp + info["output_bytes"]
                                - info["alias_bytes"]),
    }
    rec["cost_analysis"] = {"flops": flops, "bytes_accessed": hbm}
    coll_total = float(sum(coll_bytes.values()))
    rec["hlo"] = {
        "flops_per_device": flops,
        "collective_bytes": coll_bytes,
        "collective_total": coll_total,
        "num_collectives": coll_count,
        "hbm_bytes": hbm,
        "while_trips": info["while_trips"],
        "trip_hints": hints,
        "graph_nodes": len(graph.nodes),
    }
    rec["roofline"] = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm / HBM_BW,
        "collective_s": coll_total / NVLINK_BW,
    }
    rec["roofline"]["dominant"] = max(rec["roofline"], key=rec["roofline"].get)
    tokens = cell.global_batch * (cell.seq_len if cell.mode != "decode" else 1)
    n_active = cfg.active_param_count()
    mf = 6 * n_active * tokens if cell.mode == "train" else 2 * n_active * tokens
    rec["model_flops_global"] = float(mf)
    rec["useful_ratio"] = float(mf / max(flops * chips, 1.0))

    if map_placement:
        rec["map"] = map_graph(graph, multi_pod, rec["roofline"]["collective_s"], device)
    if keep_graph:
        rec["_graph"] = graph
    return rec


def map_graph(graph, multi_pod: bool, collective_s: float, device=None) -> dict:
    """The traced graph's communication TaskGraph mapped by ``shared_map``
    (``fast``) onto the physical hierarchy, against the default placement."""
    from ..core.api import SharedMapConfig, shared_map
    from ..core.mapping import evaluate_J
    from .comm_graph import default_placement, extract_fx_graph
    from .mesh import physical_hierarchy

    h = physical_hierarchy(multi_pod)
    t0 = time.time()
    tg = extract_fx_graph(graph, min_tasks=2 * h.k)
    extract_s = time.time() - t0
    if tg.n < h.k:
        return {"skipped": f"graph has {tg.n} tasks < k={h.k}"}
    g = tg.to_graph(device=device if device is not None else "cuda")
    t0 = time.time()
    res = shared_map(g, h, SharedMapConfig(preset="fast"), device=device)
    map_s = time.time() - t0
    j_def = evaluate_J(g, h, default_placement(tg.n, h.k), device=device)
    return {
        "tasks": tg.n, "task_edges": tg.m,
        "granularity": tg.meta["granularity"],
        "extract_s": round(extract_s, 2),
        "map_s": round(map_s, 2),
        "J_sharedmap": res.J, "J_default": j_def,
        "improvement": j_def / max(res.J, 1e-12),
        "roofline_collective_s": collective_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--map", action="store_true", dest="map_placement",
                    help="extract the traced step's communication graph and SharedMap "
                         "it onto the physical hierarchy (closed loop); adds a 'map' "
                         "record with J vs the default placement")
    ap.add_argument("--device", default=None,
                    help="where --map maps: the card (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    # the fake world first, as the reference forces its host devices first
    ensure_fake_world(512 if meshes[0] == "pod2" else 256)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if "error" not in r:
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    cells = []
    for arch in ([args.arch] if args.arch else ARCHS):
        cfg = get_config(arch)
        for cell in SHAPES:
            if args.shape and cell.name != args.shape:
                continue
            ok, why = cell_applicable(cfg, cell)
            for mname in meshes:
                if (arch, cell.name, mname) in done:
                    continue
                cells.append((arch, cell, mname, ok, why))

    with open(args.out, "a") as f:
        for arch, cell, mname, ok, why in cells:
            tag = f"{arch} x {cell.name} x {mname}"
            if not ok:
                rec = {"arch": arch, "shape": cell.name, "mesh": mname, "skipped": why}
                f.write(json.dumps(rec) + "\n")
                f.flush()
                print(f"[skip] {tag}: {why}", flush=True)
                continue
            print(f"[run ] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, cell, multi_pod=(mname == "pod2"),
                               map_placement=args.map_placement, device=args.device)
                rl = rec["roofline"]
                print(f"[ ok ] {tag}: compute={rl['compute_s']:.3f}s "
                      f"mem={rl['memory_s']:.3f}s coll={rl['collective_s']:.3f}s "
                      f"dom={rl['dominant']} trace={rec['lower_s']}s", flush=True)
                mp = rec.get("map")
                if mp and "skipped" not in mp:
                    print(f"[ map] {tag}: tasks={mp['tasks']} "
                          f"J={mp['J_sharedmap']:.3g} vs default "
                          f"{mp['J_default']:.3g} "
                          f"({mp['improvement']:.2f}x better)", flush=True)
            except Exception as e:  # record failures; the sweep continues
                rec = {"arch": arch, "shape": cell.name, "mesh": mname,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}", flush=True)
            f.write(json.dumps(rec) + "\n")
            f.flush()
    stop_world()


if __name__ == "__main__":
    main()
