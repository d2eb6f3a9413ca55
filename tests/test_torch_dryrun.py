"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``) against the
JAX package's own records, on the CPU.

``tests/data/dryrun/*.json`` hold the reference's dry-run records of three
cells (``make_dryrun_fixtures.py`` runs its CLI): whisper-tiny x train_4k,
moonshot-v1-16b-a3b x decode_32k (expert parallelism at V = 16, E_loc 4,
the KV-cache specs) and llama3.2-3b x decode_32k (a KV cache sharded over
its sequence), all on the pod1 mesh of 256 ranks. The port
records one rank's step on torch's fake world of 256 ranks, each cell in a
subprocess of its own (the process group is process-global), the whisper
cell through the CLI with ``--map --device cpu``. Held: the chip count and
the mode, ``memory.argument_bytes`` to the byte (params, moments, batch and
cache shards under the sanitized specs), the model FLOPs, collectives of
the kinds the step needs; the per-device FLOPs and collective bytes are
printed beside the reference's (another IR: the eager step's local ops, the
layer loop unrolled, against XLA's SPMD program).
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
CELL = r'''
import json, sys
from repro_torch.configs.registry import SHAPES
from repro_torch.launch import dryrun, fx_analysis as FX
arch, shape = sys.argv[1:3]
cell = next(c for c in SHAPES if c.name == shape)
rec = dryrun.run_cell(arch, cell, multi_pod=False, keep_graph=True)
graph = rec.pop("_graph")
rec["largest_payload"] = {
    k: max(FX.collective_bytes(n) for n in graph.nodes if FX.collective_kind(n) == k)
    for k in rec["hlo"]["num_collectives"]}
print(json.dumps(rec))
'''


def _fixture(arch, shape):
    return json.loads((FIXTURES / f"{arch.replace('.', '_')}__{shape}__pod1.json").read_text())


def _run_both(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = tmp_path / "whisper.jsonl"
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
         "--shape", "train_4k", "--mesh", "pod1", "--map", "--device", "cpu",
         "--out", str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cells = [subprocess.Popen([sys.executable, "-c", CELL, arch, "decode_32k"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for arch in ("moonshot-v1-16b-a3b", "llama3.2-3b")]
    c_out, c_err = cli.communicate(timeout=300)
    assert cli.returncode == 0, c_err[-3000:]
    recs = []
    for p in cells:
        out_, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        recs.append(json.loads(out_.splitlines()[-1]))
    return json.loads(out.read_text().splitlines()[-1]), recs[0], c_out, recs[1]


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
    return _run_both(tmp_path_factory.mktemp("dryrun"))


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


def test_whisper_train_record(records):
    whisper = records[0]
    _held(whisper, "whisper-tiny", "train_4k")
    # a train step gathers weights, reduces activations and gradients
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(whisper["hlo"]["num_collectives"])


def test_moonshot_decode_record(records):
    moonshot = records[1]
    _held(moonshot, "moonshot-v1-16b-a3b", "decode_32k")
    # the expert-parallel MoE gathers its ZeRO shards and sums the experts
    assert {"all-gather", "all-reduce"} <= set(moonshot["hlo"]["num_collectives"])


def test_map_on_the_cpu(records):
    whisper, _, log, _ = records
    mp = whisper["map"]
    assert mp["tasks"] >= 512 and mp["granularity"] in ("fused", "op")
    assert mp["J_sharedmap"] > 0 and mp["J_default"] > 0
    assert mp["improvement"] == mp["J_default"] / mp["J_sharedmap"]
    assert "[ map] whisper-tiny x train_4k x pod1" in log


def test_llama_decode_on_a_sequence_sharded_cache(records):
    """llama3.2-3b's 8 kv heads do not divide the 16 model ranks, so its
    32k KV cache is sharded over the sequence. Attention runs on each
    rank's slice and reduces the softmax's statistics: no all-gather moves
    a layer's cache shard, and the FLOPs are near the reference's
    (attention over the gathered cache reads 8.2x them)."""
    llama = records[3]
    _held(llama, "llama3.2-3b", "decode_32k")
    cfg = get_config("llama3.2-3b")
    shard = llama["memory"]["alias_bytes"] // (2 * cfg.num_layers)   # one layer's k
    assert shard == 8 * 2048 * cfg.num_kv_heads * cfg.head_dim * 2   # [B/16, S/16, Hkv, Dh] bf16
    assert llama["largest_payload"]["all-gather"] < shard
    # the softmax's max and sum, and the weighted sum of v, in every layer
    assert llama["hlo"]["num_collectives"]["all-reduce"] >= 3 * cfg.num_layers
    ratio = llama["hlo"]["flops_per_device"] / _fixture("llama3.2-3b", "decode_32k")["hlo"][
        "flops_per_device"]
    assert ratio < 1.25, ratio
