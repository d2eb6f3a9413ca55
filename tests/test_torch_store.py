"""The port's result store (``repro_torch.serve.store``) and fault injector
(``repro_torch.faults``) against the JAX package's on the CPU: ``RST1``
entries byte-identical for the same result, a store written by either
package read by the other, corrupt entries (truncated, bit-flipped, torn
by the ``store_write`` seam) quarantined and never served, the injector's
decisions equal to the reference's, and a real port ``shared_map`` result
round-tripped."""
import json
import os

import numpy as np
import pytest

from repro import faults as JF
from repro.core.api import SharedMapResult as JResult
from repro.serve import store as JS
from repro_torch import faults as TF
from repro_torch.core import graph as TG
from repro_torch.core.api import SharedMapConfig, SharedMapResult, shared_map
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.serve import store as TS

FP = bytes(range(16))
GFP = bytes(range(16, 32))


def _result(n=32, k=4, seed=0, dtype=np.int32):
    rng = np.random.default_rng(seed)
    return SharedMapResult(
        pe_of=rng.integers(0, k, size=n).astype(dtype), J=float(rng.uniform(0, 100)),
        stats={"strategy": "device", "levels": [{"k": k, "seconds": 0.25}],
               "partition_calls": 3, "refined": True,
               "np": {"i": np.int64(7), "f": np.float32(0.5), "a": np.arange(3)}})


def _as_reference(res: SharedMapResult) -> JResult:
    return JResult(pe_of=res.pe_of, J=res.J, stats=res.stats)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_entry_byte_identical(seed, dtype):
    res = _result(seed=seed, dtype=dtype)
    blob = TS.encode_entry(FP, GFP, res)
    assert blob == JS.encode_entry(FP, GFP, _as_reference(res))
    for decode in (TS.decode_entry, JS.decode_entry):
        got, gfp = decode(blob, FP)
        assert gfp == GFP and got.J == res.J
        assert got.pe_of.dtype == res.pe_of.dtype and np.array_equal(got.pe_of, res.pe_of)
        assert got.stats["np"] == {"i": 7, "f": 0.5, "a": [0, 1, 2]}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer):
    path = str(tmp_path / "store")
    fps = [bytes([i]) * 16 for i in range(3)]
    results = [_result(seed=i) for i in range(3)]
    if writer == "port":
        w, r, conv = TS.ResultStore(path), JS.ResultStore, _as_reference
    else:
        w, r, conv = JS.ResultStore(path), TS.ResultStore, lambda x: x
    for fp, res in zip(fps, results):
        assert w.put(fp, GFP, conv(res))
    reader = r(path)
    assert reader.stats()["entries_on_open"] == 3
    for fp, res in zip(fps, results):
        got, gfp = reader.get(fp)
        assert gfp == GFP and got.J == res.J and np.array_equal(got.pe_of, res.pe_of)
        assert got.pe_of.dtype == res.pe_of.dtype
    assert sorted(reader.keys()) == sorted(fps)


@pytest.mark.parametrize("damage", ["truncate-0", "truncate-3", "truncate-10", "truncate-half",
                                    "truncate-last", "bitflip-header", "bitflip-payload",
                                    "magic", "torn-write"])
def test_corrupt_entries_quarantined_never_served(tmp_path, damage):
    inj = TF.FaultInjector(fail_at={"store_write": (0,)}) if damage == "torn-write" \
        else TF.NULL_INJECTOR
    st = TS.ResultStore(str(tmp_path / "store"), fault_injector=inj)
    assert st.put(FP, GFP, _result())
    path = st._entry_path(FP)
    blob = bytearray(open(path, "rb").read())
    kind, _, arg = damage.partition("-")
    if kind == "truncate":
        cut = {"half": len(blob) // 2, "last": len(blob) - 1}.get(arg) or int(arg)
        blob = blob[:cut]
    elif kind == "bitflip":
        blob[30 if arg == "header" else len(blob) - 3] ^= 0x40
    elif kind == "magic":
        blob[:4] = b"XXXX"
    with open(path, "wb") as f:
        f.write(bytes(blob))
    assert st.get(FP) is None
    assert not os.path.exists(path)
    s = st.stats()
    assert s["corrupt"] == 1 and s["quarantined"] == 1 and s["misses"] == 1
    assert FP.hex() + ".res" in os.listdir(st.quarantine_dir)
    with pytest.raises(JS.CorruptEntryError):   # the reference rejects the bytes too
        JS.decode_entry(bytes(blob), FP)
    assert st.put(FP, GFP, _result())            # a clean rewrite serves again
    assert st.get(FP) is not None


def test_decode_rejects_a_misfiled_entry():
    blob = TS.encode_entry(FP, GFP, _result())
    with pytest.raises(TS.CorruptEntryError, match="fingerprint"):
        TS.decode_entry(blob, GFP)


def test_tmp_files_swept_on_open(tmp_path):
    path = str(tmp_path / "store")
    st = TS.ResultStore(path)
    orphan = os.path.join(st._tmp_dir, "deadbeef.123.1")
    with open(orphan, "wb") as f:
        f.write(b"partial")
    assert TS.ResultStore(path).stats()["entries_on_open"] == 0
    assert not os.path.exists(orphan)


def _decisions(mod, seed, plan, n=300):
    inj = mod.FaultInjector(seed=seed, **plan)
    out = []
    for i in range(n):
        for site in ("dispatch", "cache", "store_write"):
            try:
                inj.check(site, index=i if site == "cache" else None)
                out.append(0)
            except mod.InjectedFault as e:
                out.append((e.site, e.index, e.transient))
    return out, inj.fired, {s: inj.count(s) for s in ("dispatch", "cache", "store_write")}


@pytest.mark.parametrize("seed", [0, 5, 123])
@pytest.mark.parametrize("plan", [
    {"rates": {"dispatch": 0.3, "store_write": 0.05}},
    {"fail_at": {"dispatch": (1, 4), "cache": (7, 7, 250)}, "rates": {"cache": 0.1}},
    {"fail_at": {"store_write": (0,)}, "transient": False},
])
def test_fault_injector_decisions_equal_the_reference(seed, plan):
    assert _decisions(TF, seed, plan) == _decisions(JF, seed, plan)


def test_hash_uniform_equals_the_reference():
    for seed in (0, 1, 2**40):
        for site in ("dispatch", "store_write", "ü"):
            vals = [TF._hash_uniform(seed, site, c) for c in range(200)]
            assert vals == [JF._hash_uniform(seed, site, c) for c in range(200)]
            assert all(0.0 <= v < 1.0 for v in vals)
    for _ in range(50):
        TF.NULL_INJECTOR.check("dispatch")


@pytest.mark.parametrize("strategy", ["bucket", "device", "naive"])
def test_real_port_result_round_trips(tmp_path, strategy):
    tg = TaskGraph.from_graph(TG.gen_grid(12, device="cpu"))
    res = shared_map(tg, Hierarchy((4, 2), (1.0, 10.0)),
                     SharedMapConfig(preset="fast", strategy=strategy, refine_mapping=True),
                     device="cpu")
    json.dumps(res.stats)   # plain Python values only: no default= needed
    blob = TS.encode_entry(tg.fingerprint(), tg.fingerprint(), res)
    assert blob == JS.encode_entry(tg.fingerprint(), tg.fingerprint(), _as_reference(res))
    st = TS.ResultStore(str(tmp_path / "store"))
    assert st.put(tg.fingerprint(), tg.fingerprint(), res)
    got, gfp = JS.ResultStore(str(tmp_path / "store")).get(tg.fingerprint())
    assert gfp == tg.fingerprint() and got.J == res.J
    assert got.pe_of.dtype == np.int32 and np.array_equal(got.pe_of, res.pe_of)
    assert got.stats["refined"] is True and got.stats["levels"] == res.stats["levels"]
