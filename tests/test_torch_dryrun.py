"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``) against the
JAX package's own records, on the CPU.

``tests/data/dryrun/*.json`` hold the reference's dry-run records of six
cells (``make_dryrun_fixtures.py`` runs its CLI): whisper-tiny x train_4k,
moonshot-v1-16b-a3b x decode_32k (expert parallelism at V = 16, E_loc 4,
the KV-cache specs), llama3.2-3b x decode_32k (a KV cache sharded over its
sequence), llama3.2-3b x train_4k and qwen2-72b x prefill_32k (kv heads
that do not divide the model axis, so attention is split by (batch row, kv
group) units) and jamba-v0.1-52b x prefill_32k (Mamba's SSD on each rank's
heads), all on the pod1 mesh of 256 ranks. The port records one
rank's step on torch's fake world of 256 ranks in subprocesses (the
process group is process-global), the whisper cell through the CLI with
``--map --device cpu``. Held: the chip
count and the mode, ``memory.argument_bytes`` to the byte (params,
moments, the batch leaves the step reads and cache shards under the
sanitized specs), the model FLOPs, the per-device FLOPs within 2% of
their measured ratio to the reference's (``flops_ratio.json``) and
``useful_ratio`` at most 1,
collectives of the kinds the step needs; collective bytes are printed
beside the reference's (another IR: the eager step's local ops, the layer
loop unrolled, against XLA's SPMD program).
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
CELLS = r'''
import json, sys
from repro_torch.configs.registry import SHAPES
from repro_torch.launch import dryrun, fx_analysis as FX
for arg in sys.argv[1:]:
    arch, shape = arg.split(":")
    cell = next(c for c in SHAPES if c.name == shape)
    rec = dryrun.run_cell(arch, cell, multi_pod=False, keep_graph=True)
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
RECORDERS = 2     # subprocesses recording the cells beside the CLI's


def _fixture(arch, shape):
    return json.loads((FIXTURES / f"{arch.replace('.', '_')}__{shape}__pod1.json").read_text())


def _run_all(tmp_path):
    """The whisper cell through the CLI, the other cells shared out over
    RECORDERS subprocesses, each recording its cells one after another (the
    fake process group is process-global), all at once: ({(arch, shape):
    record}, the CLI's log)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = tmp_path / "whisper.jsonl"
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
         "--shape", "train_4k", "--mesh", "pod1", "--map", "--device", "cpu",
         "--out", str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cells = [cell for cell in FLOPS_RATIO if cell != ("whisper-tiny", "train_4k")]
    procs = [subprocess.Popen([sys.executable, "-c", CELLS,
                               *(f"{a}:{s}" for a, s in cells[i::RECORDERS])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(RECORDERS)]
    c_out, c_err = cli.communicate(timeout=300)
    assert cli.returncode == 0, c_err[-3000:]
    recs = {("whisper-tiny", "train_4k"): json.loads(out.read_text().splitlines()[-1])}
    for p in procs:
        out_, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        for line in out_.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                recs[(rec["arch"], rec["shape"])] = rec
    assert set(recs) == set(FLOPS_RATIO)
    return recs, c_out


def _beside(rec, ref) -> str:
    h, rh = rec["hlo"], ref["hlo"]
    kinds = sorted(set(h["collective_bytes"]) | set(rh["collective_bytes"]))
    coll = ", ".join(f"{k} {h['collective_bytes'].get(k, 0):.6g} / {rh['collective_bytes'].get(k, 0):.6g}"
                     for k in kinds)
    return (f"{rec['arch']} x {rec['shape']}: FLOPs/device {h['flops_per_device']:.6g} / "
            f"{rh['flops_per_device']:.6g} (ratio {h['flops_per_device'] / rh['flops_per_device']:.4f}); "
            f"collective bytes {h['collective_total']:.6g} / {rh['collective_total']:.6g} "
            f"(ratio {h['collective_total'] / rh['collective_total']:.4f}; {coll}); "
            f"record {rec['lower_s']} s")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("dryrun"))


def _held(rec, arch, shape):
    ref = _fixture(arch, shape)
    assert "error" not in rec, rec.get("trace")
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, "pod1")
    assert rec["chips"] == ref["chips"] == 256
    assert rec["mode"] == ref["mode"]
    assert rec["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    # every byte the step updates in place (train state, decode cache) aliases
    assert rec["memory"]["alias_bytes"] == ref["memory"]["alias_bytes"]
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
    want = FLOPS_RATIO[(arch, shape)]
    ratio = rec["hlo"]["flops_per_device"] / ref["hlo"]["flops_per_device"]
    assert abs(ratio / want - 1) <= RATIOS["within"], (arch, shape, ratio, want)
    # model FLOPs over every rank's: above 1 the record would have lost work
    assert 0 < rec["useful_ratio"] <= 1.0, rec["useful_ratio"]


def test_whisper_train_record(records):
    whisper = records[0][("whisper-tiny", "train_4k")]
    _held(whisper, "whisper-tiny", "train_4k")
    # a train step gathers weights, reduces activations and gradients
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(whisper["hlo"]["num_collectives"])


def test_moonshot_decode_record(records):
    moonshot = records[0][("moonshot-v1-16b-a3b", "decode_32k")]
    _held(moonshot, "moonshot-v1-16b-a3b", "decode_32k")
    # the expert-parallel MoE gathers its ZeRO shards and sums the experts
    assert {"all-gather", "all-reduce"} <= set(moonshot["hlo"]["num_collectives"])


def test_map_on_the_cpu(records):
    recs, log = records
    mp = recs[("whisper-tiny", "train_4k")]["map"]
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
    llama = records[0][("llama3.2-3b", "decode_32k")]
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
    rec = records[0][(arch, shape)]
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
    rec = records[0][("jamba-v0.1-52b", "prefill_32k")]
    _held(rec, "jamba-v0.1-52b", "prefill_32k")
    _, H, _ = mamba_dims(get_config("jamba-v0.1-52b"))
    chunks = rec["global_batch"] // 16 * rec["seq_len"] // 128   # apply_mamba's chunk
    assert rec["largest_bmm_batch"] * 16 <= chunks * H
