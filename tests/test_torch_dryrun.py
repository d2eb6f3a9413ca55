"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``) against the
JAX package's own records, on the CPU.

``tests/data/dryrun/*.json`` hold the reference's dry-run records of ten
cells (``make_dryrun_fixtures.py`` runs its CLI): whisper-tiny x train_4k
on pod1 and on pod2 (512 ranks, the batch over ``pod`` and ``data``),
moonshot-v1-16b-a3b x decode_32k (expert parallelism at V = 16, E_loc 4,
the KV-cache specs), llama3.2-3b x decode_32k (a KV cache sharded over its
sequence), llama3.2-3b x train_4k and qwen2-72b x prefill_32k (kv heads
that do not divide the model axis, so attention is split by (batch row, kv
group) units), jamba-v0.1-52b x prefill_32k (Mamba's SSD on each rank's
heads), train_4k and decode_32k (alias bytes), and xlstm-125m x train_4k
(the sLSTM's time scan as a loop region of the recorder). The port records
one rank's step on torch's fake world in subprocesses (the process group
is process-global), the whisper pod1 cell through the CLI with ``--map
--device cpu``. Held: the chip count and the mode, ``memory.argument_bytes``
and ``alias_bytes`` to the byte (params, moments, the batch leaves the step
reads and cache shards under the sanitized specs; jamba's alias bytes above
the reference's by the leaves its XLA does not alias), the model FLOPs, the
per-device FLOPs within 2% of their measured ratio to the reference's
(``flops_ratio.json``) and ``useful_ratio`` at most 1, collectives of the
kinds the step needs; collective bytes are printed beside the reference's
(another IR: the eager step's local ops, the layer loop unrolled, against
XLA's SPMD program). The loop region is held against the same step with
every position recorded, and ``sweep.json`` (every applicable cell, both
meshes, both sides) is held for its bytes and FLOP bands.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.registry import get_config

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "dryrun"
# each cell's per-device FLOPs over the reference's record, as measured,
# and the relative band it is held within (chip_smoke.py phase 14 holds the
# same under the card's torch): each rank computes its own share of every
# attention and product, as the reference's SPMD program does, under any
# torch release
RATIOS = json.loads((FIXTURES / "flops_ratio.json").read_text())
FLOPS_RATIO = {tuple(k.split(" x ")): v for k, v in RATIOS["ratio"].items()}
# the sweep table: every applicable cell of all_cells() on both meshes, the
# reference's record beside the port's (make_dryrun_fixtures.py --table)
SWEEP = json.loads((FIXTURES / "sweep.json").read_text())["cells"]
CELLS = r'''
import json, sys
from repro_torch.configs.registry import SHAPES
from repro_torch.launch import dryrun, fx_analysis as FX
for arg in sys.argv[1:]:
    arch, shape, mesh = arg.split(":")
    cell = next(c for c in SHAPES if c.name == shape)
    rec = dryrun.run_cell(arch, cell, multi_pod=mesh == "pod2", keep_graph=True)
    graph = rec.pop("_graph")
    rec["largest_payload"] = {
        k: max(FX.collective_bytes(n) for n in graph.nodes if FX.collective_kind(n) == k)
        for k in rec["hlo"]["num_collectives"]}
    rec["largest_bmm_batch"] = max((FX._shape(n)[0] for n in graph.nodes
                                    if FX.is_task(n) and FX._op_name(n) == "bmm"), default=0)
    rec["global_batch"], rec["seq_len"] = cell.global_batch, cell.seq_len
    del graph
    print(json.dumps(rec), flush=True)
'''
# the smoke xLSTM's train step (one sLSTM and one mLSTM layer) on a 2 x 2
# fake mesh at S = 16, recorded with the sLSTM's time scan as a loop region
# and with every step run: the totals of each record, per time chunk
REGION = r'''
import dataclasses, json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs.registry import ShapeCell, get_smoke_config
from repro_torch.launch import dryrun, fx_analysis as FX
from repro_torch.launch.mesh import start_fake_world, stop_world
start_fake_world(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(get_smoke_config("xlstm-125m"), num_layers=2)
out = {}
for tc in (1, 4):
    ctx = dryrun.make_ctx(mesh, False, global_batch=4, slstm_chunk=tc)
    for regions in (True, False):
        graph, _, info = dryrun.lower_cell(cfg, ShapeCell("t", 16, 4, "train"), mesh, ctx,
                                           scan_regions=regions)
        out[f"{tc}:{regions}"] = {
            "flops": FX.total_flops(graph), "collectives": FX.collective_totals(graph),
            "hbm": dryrun.hbm_bytes(graph), "while_trips": info["while_trips"],
            "nodes": len(graph.nodes),
            "trips": sorted({FX.node_trips(n) for n in graph.nodes})}
stop_world()
print(json.dumps(out), flush=True)
'''
# the cells recorded beside the CLI's, one subprocess a group (each records
# its cells one after another: the fake process group is process-global),
# grouped so that each takes about as long
RECORDED = ((("jamba-v0.1-52b", "train_4k", "pod1"), ("llama3.2-3b", "decode_32k", "pod1")),
            (("xlstm-125m", "train_4k", "pod1"), ("jamba-v0.1-52b", "decode_32k", "pod1")),
            (("whisper-tiny", "train_4k", "pod2"), ("llama3.2-3b", "train_4k", "pod1")),
            (("qwen2-72b", "prefill_32k", "pod1"), ("jamba-v0.1-52b", "prefill_32k", "pod1"),
             ("moonshot-v1-16b-a3b", "decode_32k", "pod1")))


def _fixture(arch, shape, mesh="pod1"):
    return json.loads((FIXTURES / f"{arch.replace('.', '_')}__{shape}__{mesh}.json").read_text())


def _run_all(tmp_path):
    """The whisper cell through the CLI, each group of RECORDED in a
    subprocess, and the loop-region records, all at once: ({(arch, shape,
    mesh): record}, the CLI's log, the region records)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = tmp_path / "whisper.jsonl"
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
         "--shape", "train_4k", "--mesh", "pod1", "--map", "--device", "cpu",
         "--out", str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [subprocess.Popen([sys.executable, "-c", CELLS, *(":".join(c) for c in group)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for group in RECORDED]
    region = subprocess.Popen([sys.executable, "-c", REGION], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    c_out, c_err = cli.communicate(timeout=300)
    assert cli.returncode == 0, c_err[-3000:]
    recs = {("whisper-tiny", "train_4k", "pod1"): json.loads(out.read_text().splitlines()[-1])}
    for p in procs:
        out_, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        for line in out_.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    r_out, r_err = region.communicate(timeout=300)
    assert region.returncode == 0, r_err[-3000:]
    assert set(recs) == {("whisper-tiny", "train_4k", "pod1"), *(c for g in RECORDED for c in g)}
    return recs, c_out, json.loads(r_out.splitlines()[-1])


def _beside(rec, ref) -> str:
    h, rh = rec["hlo"], ref["hlo"]
    kinds = sorted(set(h["collective_bytes"]) | set(rh["collective_bytes"]))
    coll = ", ".join(f"{k} {h['collective_bytes'].get(k, 0):.6g} / {rh['collective_bytes'].get(k, 0):.6g}"
                     for k in kinds)
    return (f"{rec['arch']} x {rec['shape']} x {rec['mesh']}: FLOPs/device {h['flops_per_device']:.6g} / "
            f"{rh['flops_per_device']:.6g} (ratio {h['flops_per_device'] / rh['flops_per_device']:.4f}); "
            f"collective bytes {h['collective_total']:.6g} / {rh['collective_total']:.6g} "
            f"(ratio {h['collective_total'] / rh['collective_total']:.4f}; {coll}); "
            f"record {rec['lower_s']} s")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("dryrun"))


def _held(rec, arch, shape, mesh="pod1", alias_extra=0):
    """``rec`` against the reference's fixture; ``alias_extra``: the bytes
    the port updates in place that the reference's XLA does not alias."""
    ref = _fixture(arch, shape, mesh)
    assert "error" not in rec, rec.get("trace")
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, mesh)
    assert rec["chips"] == ref["chips"] == (512 if mesh == "pod2" else 256)
    assert rec["mode"] == ref["mode"]
    assert rec["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    # every byte the step updates in place (train state, decode cache) aliases
    assert rec["memory"]["alias_bytes"] == ref["memory"]["alias_bytes"] + alias_extra
    assert rec["model_flops_global"] == ref["model_flops_global"]
    # the reference's record keys, and its roofline's (which the fixture drops)
    for k, v in ref.items():
        if k != "jax_version":
            assert k in rec, k
            if isinstance(v, dict):
                assert set(v) - {"while_trips"} <= set(rec[k]), k
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant"}
    assert rec["hlo"]["flops_per_device"] > 0
    print(_beside(rec, ref))
    want = FLOPS_RATIO[(arch, shape, mesh)]
    ratio = rec["hlo"]["flops_per_device"] / ref["hlo"]["flops_per_device"]
    assert abs(ratio / want - 1) <= RATIOS["within"], (arch, shape, ratio, want)
    # model FLOPs over every rank's: above 1 the record would have lost work
    assert 0 < rec["useful_ratio"] <= 1.0, rec["useful_ratio"]


def test_whisper_train_record(records):
    whisper = records[0][("whisper-tiny", "train_4k", "pod1")]
    _held(whisper, "whisper-tiny", "train_4k")
    # a train step gathers weights, reduces activations and gradients
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(whisper["hlo"]["num_collectives"])


def test_moonshot_decode_record(records):
    moonshot = records[0][("moonshot-v1-16b-a3b", "decode_32k", "pod1")]
    _held(moonshot, "moonshot-v1-16b-a3b", "decode_32k")
    # the expert-parallel MoE gathers its ZeRO shards and sums the experts
    assert {"all-gather", "all-reduce"} <= set(moonshot["hlo"]["num_collectives"])


def test_map_on_the_cpu(records):
    recs, log, _ = records
    mp = recs[("whisper-tiny", "train_4k", "pod1")]["map"]
    assert mp["tasks"] >= 512 and mp["granularity"] in ("fused", "op")
    assert mp["J_sharedmap"] > 0 and mp["J_default"] > 0
    assert mp["improvement"] == mp["J_default"] / mp["J_sharedmap"]
    assert "[ map] whisper-tiny x train_4k x pod1" in log


def test_llama_decode_on_a_sequence_sharded_cache(records):
    """llama3.2-3b's 8 kv heads do not divide the 16 model ranks, so its
    32k KV cache is sharded over the sequence. Attention runs on each
    rank's slice and reduces the softmax's statistics: no all-gather moves
    a layer's cache shard, and the FLOPs are at most the reference's
    (``FLOPS_RATIO``; attention over the gathered cache reads 8.2x them)."""
    llama = records[0][("llama3.2-3b", "decode_32k", "pod1")]
    _held(llama, "llama3.2-3b", "decode_32k")
    cfg = get_config("llama3.2-3b")
    shard = llama["memory"]["alias_bytes"] // (2 * cfg.num_layers)   # one layer's k
    assert shard == 8 * 2048 * cfg.num_kv_heads * cfg.head_dim * 2   # [B/16, S/16, Hkv, Dh] bf16
    assert llama["largest_payload"]["all-gather"] < shard
    # the softmax's max and sum, and the weighted sum of v, in every layer
    assert llama["hlo"]["num_collectives"]["all-reduce"] >= 3 * cfg.num_layers


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", "train_4k"),
                                        ("qwen2-72b", "prefill_32k")])
def test_attention_split_over_model_units(records, arch, shape):
    """Neither cell's kv heads (8) divide the 16 model ranks: each rank
    attends its share of the (batch row, kv group) units (llama3.2-3b x
    train_4k: 16 rows x 8 groups, 8 a rank; qwen2-72b x prefill_32k: 2 x 8,
    one a rank), moved there and back by all-to-all; no batched product
    holds more than a rank's share of the heads."""
    rec = records[0][(arch, shape, "pod1")]
    _held(rec, arch, shape)
    cfg = get_config(arch)
    assert cfg.num_kv_heads % 16 and cfg.num_kv_heads < 16
    assert rec["hlo"]["num_collectives"]["all-to-all"] >= 4 * cfg.num_layers
    assert rec["largest_bmm_batch"] * 16 <= rec["global_batch"] // 16 * cfg.num_heads


def test_jamba_prefill_splits_the_ssd_by_heads(records):
    """jamba's Mamba layers: u and z come from in_proj's halves, each
    column-parallel, so they stay sharded by heads over the 16 model ranks,
    and the SSD runs on each rank's heads (``mamba._ssd``): no batched
    product holds more than a rank's share of the chunks x heads."""
    from repro_torch.models.mamba import mamba_dims
    rec = records[0][("jamba-v0.1-52b", "prefill_32k", "pod1")]
    _held(rec, "jamba-v0.1-52b", "prefill_32k")
    _, H, _ = mamba_dims(get_config("jamba-v0.1-52b"))
    chunks = rec["global_batch"] // 16 * rec["seq_len"] // 128   # apply_mamba's chunk
    assert rec["largest_bmm_batch"] * 16 <= chunks * H


def test_xlstm_train_records_its_time_scan_as_a_loop(records):
    """xlstm-125m x train_4k: each of its 6 sLSTM layers is a time scan of
    4,096 steps (``time_chunk`` 1). The recorder counts it from three
    iterations, the middle one times 4,094, backward included: the
    argument and alias bytes are the reference's to the byte, the FLOPs
    within the band, and ``while_trips`` lists the reference's loops (each
    layer's scan, its remat recompute and its gradient)."""
    rec = records[0][("xlstm-125m", "train_4k", "pod1")]
    _held(rec, "xlstm-125m", "train_4k")
    ref = _fixture("xlstm-125m", "train_4k")
    assert rec["hlo"]["while_trips"] == ref["hlo"]["while_trips"] == [4096] * 18
    assert rec["hlo"]["trip_hints"] == ref["hlo"]["trip_hints"]
    print(f"xlstm-125m x train_4k recorded in {rec['lower_s']} s, "
          f"{rec['hlo']['graph_nodes']} nodes")


def _mamba_layers(cfg) -> int:
    kinds = cfg.layer_kinds()
    return sum(k.split("+")[0] == "mamba" for k in kinds) * (cfg.num_layers // len(kinds))


@pytest.mark.parametrize("shape,port_alias", [("train_4k", 2_455_320_580),
                                              ("decode_32k", 277_151_744)])
def test_jamba_alias_bytes(records, shape, port_alias):
    """jamba-v0.1-52b: argument bytes the reference's to the byte; the alias
    bytes are every byte the port updates in place, above the reference's
    by the leaves its XLA cannot alias (ROADMAP.md, Queue 3):

    * train_4k: each Mamba layer's ``b_dt``, ``A_log`` and ``D_skip`` ([H]
      f32, replicated) in params, mu and nu. The reference's step returns
      them sharded over ``model`` (its jit leaves the outputs' shardings to
      XLA), so their donated buffers do not alias; the port updates them in
      place at their placement.
    * decode_32k: each Mamba layer's conv state (f32 ``[B/16, K-1,
      d_in/16]``). The reference's decode returns it in the compute dtype
      (bf16), so it cannot alias the f32 cache; the port copies it into
      the cache (bf16 values are exact in f32: the next step reads the
      same values)."""
    assert _mamba_layers(get_config("jamba-v0.1-52b")) == 28
    rec = records[0][("jamba-v0.1-52b", shape, "pod1")]
    _held(rec, "jamba-v0.1-52b", shape, alias_extra=_jamba_alias_extra(shape, "pod1"))
    assert rec["memory"]["alias_bytes"] == port_alias


def test_pod2_train_record(records):
    """whisper-tiny x train_4k on the pod2 mesh (2 x 16 x 16, 512 ranks): the
    batch is sharded over ``pod`` and ``data`` together; argument bytes the
    reference's to the byte, FLOPs within the band."""
    rec = records[0][("whisper-tiny", "train_4k", "pod2")]
    _held(rec, "whisper-tiny", "train_4k", mesh="pod2")
    pod1 = records[0][("whisper-tiny", "train_4k", "pod1")]
    # half the batch rows a rank: the pod axis takes its share of the data
    assert rec["memory"]["argument_bytes"] < pod1["memory"]["argument_bytes"]


@pytest.mark.parametrize("tc", [1, 4])
def test_loop_region_counts_what_every_step_counts(records, tc):
    """The smoke xLSTM's train step at S = 16 (``REGION``): recorded with the
    sLSTM's scan as a loop region (three iterations of ``tc`` steps, the
    middle one times 16 / tc - 2) it gives the FLOPs, collective bytes and
    counts and HBM bytes of the same step recorded with every step run, to
    the unit, backward and remat included."""
    regions, unrolled = records[2][f"{tc}:True"], records[2][f"{tc}:False"]
    for key in ("flops", "collectives", "hbm"):
        assert regions[key] == unrolled[key], key
    assert regions["trips"] == [1, 16 // tc - 2] and unrolled["trips"] == [1]
    assert regions["while_trips"] == [16 // tc] * 3 and unrolled["while_trips"] == []
    assert regions["nodes"] < unrolled["nodes"]


# the sweep's cells whose FLOPs per device leave [0.98, 1.02] of the
# reference's, each for a reason in ROADMAP.md's Queue 3
OFF_BAND = {
    # the port attends each rank's cache shard, XLA gathers the cache whole
    "llama3.2-3b x decode_32k": "cache shard",
    # XLA repeats whisper-tiny's attention on every model rank; the port splits it
    "whisper-tiny x train_4k": "whisper", "whisper-tiny x prefill_32k": "whisper",
    # XLA splits xLSTM's replicated products over the model axis at decode
    "xlstm-125m x decode_32k": "xlstm decode", "xlstm-125m x long_500k": "xlstm decode"}


def _jamba_alias_extra(shape: str, mesh: str) -> int:
    """The bytes jamba-v0.1-52b's port aliases that the reference's XLA
    does not (``test_jamba_alias_bytes``): three [H] f32 leaves a Mamba
    layer in params, mu and nu (train), or the f32 conv states (decode)."""
    from repro_torch.configs.registry import SHAPES
    from repro_torch.models.mamba import mamba_dims
    cfg = get_config("jamba-v0.1-52b")
    d_in, H, _ = mamba_dims(cfg)
    cell = next(c for c in SHAPES if c.name == shape)
    if cell.mode == "train":
        return 3 * _mamba_layers(cfg) * 3 * H * 4
    if cell.mode == "prefill":
        return 0
    ranks = 32 if mesh == "pod2" and cell.global_batch % 32 == 0 else 16
    rows = cell.global_batch // ranks if cell.global_batch % ranks == 0 else cell.global_batch
    return _mamba_layers(cfg) * rows * (cfg.mamba_d_conv - 1) * (d_in // 16) * 4


def test_sweep_table_covers_every_cell():
    """The committed sweep table holds every applicable cell of
    ``all_cells()`` on pod1 and pod2, recorded on both sides: argument
    bytes the reference's to the byte in every cell, alias bytes too but
    for jamba's leaves that the reference's XLA does not alias, and FLOPs
    per device within [0.98, 1.02] of the reference's but for the cells of
    ``OFF_BAND``."""
    from repro_torch.configs.registry import all_cells
    want = {f"{arch} x {cell.name} x {mesh}"
            for arch, _, cell, ok, _ in all_cells() if ok for mesh in ("pod1", "pod2")}
    assert want <= set(SWEEP) and len(want) == 66
    for key in want:
        row = SWEEP[key]
        assert "argument_bytes" in row["reference"], (key, row["reference"])
        assert "argument_bytes" in row["port"], (key, row["port"])
        assert row["argument_bytes_equal"], key
        arch, shape, mesh = key.split(" x ")
        extra = _jamba_alias_extra(shape, mesh) if arch == "jamba-v0.1-52b" else 0
        assert row["port"]["alias_bytes"] == row["reference"]["alias_bytes"] + extra, key
        if f"{arch} x {shape}" not in OFF_BAND:
            assert 0.98 <= row["flops_ratio"] <= 1.02, (key, row["flops_ratio"])
