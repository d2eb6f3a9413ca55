"""Durability of the port's mapping service on the CPU: warm restart from
the persistent store, corrupt and torn entries contained, worker mode with
SIGKILL recovery, shadow verification (match and mismatch), and a store
written by the JAX package's ``MappingService`` served by the port's as a
store hit, bit for bit, and the reverse."""
import os
import time

import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.api import SharedMapConfig as JConfig
from repro.core.hierarchy import Hierarchy as JH
from repro.serve.mapper import MappingService as JService
from repro_torch.core import api as capi
from repro_torch.core import graph as TG
from repro_torch.core.api import SharedMapConfig, shared_map_direct
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.faults import FaultInjector
from repro_torch.serve.mapper import MappingService, request_fingerprint
from repro_torch.serve.tracker import InMemoryTracker

H = Hierarchy(a=(2, 2), d=(1.0, 10.0))
CFG = SharedMapConfig(preset="fast")


def _jring(n=48):
    u = np.arange(n - 1)
    return JG.from_edges(n, u, u + 1)


def _ring(n=48):
    jg = _jring(n)
    return TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in TG.Graph._fields},
                               device="cpu")


def _svc(**kw):
    kw.setdefault("batch_window_s", 0.0)
    return MappingService(device="cpu", **kw)


def _same(res, ref):
    assert np.array_equal(res.pe_of, ref.pe_of) and res.J == ref.J
    assert res.pe_of.dtype == ref.pe_of.dtype


# ---------------------------------------------------------------- store tier

def test_warm_restart_reloads_bit_identical(tmp_path):
    g = _ring()
    path = str(tmp_path / "store")
    svc = _svc(store_path=path)
    cold = svc.submit(g, H, CFG).result(timeout=120)
    svc.close()

    svc2 = _svc(store_path=path)  # a "restarted process"
    warm = svc2.submit(g, H, CFG).result(timeout=120)
    s = svc2.stats()
    svc2.close()
    _same(warm, cold)
    assert warm.stats["result_cache"]["hit"] is True
    assert s["store"]["hits"] == 1 and s["store"]["entries_on_open"] >= 1


def test_store_shared_between_live_services(tmp_path):
    g = _ring()
    path = str(tmp_path / "store")
    with _svc(store_path=path) as a, _svc(store_path=path) as b:
        ra = a.submit(g, H, CFG).result(timeout=120)
        rb = b.submit(g, H, CFG).result(timeout=120)
        _same(rb, ra)
        assert b.stats()["store"]["hits"] == 1


def test_corrupt_store_entry_recomputed_service_stays_up(tmp_path):
    g = _ring()
    path = str(tmp_path / "store")
    svc = _svc(store_path=path)
    first = svc.submit(g, H, CFG).result(timeout=120)
    svc.close()

    entry = os.path.join(path, request_fingerprint(g, H, CFG, device="cpu").hex() + ".res")
    blob = bytearray(open(entry, "rb").read())
    blob[len(blob) // 2] ^= 0x01  # single bit flip
    with open(entry, "wb") as f:
        f.write(bytes(blob))

    svc2 = _svc(store_path=path)
    res = svc2.submit(g, H, CFG).result(timeout=120)  # recomputed, not served
    s = svc2.stats()
    again = svc2.submit(_ring(40), H, CFG).result(timeout=120)
    svc2.close()
    _same(res, first)
    assert s["store"]["corrupt"] == 1 and s["store"]["quarantined"] == 1
    assert res.stats["result_cache"]["hit"] is False
    assert again.pe_of.shape[0] == 40


def test_torn_write_injection_roundtrip(tmp_path):
    g = _ring()
    path = str(tmp_path / "store")
    inj = FaultInjector(fail_at={"store_write": (0,)})
    svc = _svc(store_path=path, fault_injector=inj)
    first = svc.submit(g, H, CFG).result(timeout=120)
    svc.close()
    assert ("store_write", 0) in inj.fired

    svc2 = _svc(store_path=path)
    res = svc2.submit(g, H, CFG).result(timeout=120)
    s = svc2.stats()
    svc2.close()
    _same(res, first)
    assert s["store"]["corrupt"] == 1 and res.stats["result_cache"]["hit"] is False


def test_degraded_results_not_persisted(tmp_path):
    inj = FaultInjector(fail_at={"dispatch": tuple(range(8))})
    svc = _svc(store_path=str(tmp_path / "store"), fault_injector=inj,
               degrade_on_failure=True)
    res = svc.submit(_ring(), H, CFG).result(timeout=120)
    s = svc.stats()
    svc.close()
    assert res.stats["degradation"]["level"] > 0
    assert s["store"]["writes"] == 0 and s["store"]["entries"] == 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_written_by_one_package_served_by_the_other(tmp_path, writer):
    """The two packages key a request alike and write the same entries, so
    each service serves the other's store as a hit, bit for bit."""
    path = str(tmp_path / "store")
    jg, g = _jring(), _ring()
    jh = JH(a=(2, 2), d=(1.0, 10.0))
    jcfg = JConfig(preset="fast")
    ref_svc = JService(store_path=path, batch_window_s=0.0)
    try:
        if writer == "reference":
            first = ref_svc.submit(jg, jh, jcfg).result(timeout=300)
            ref_svc.close()
            svc = _svc(store_path=path)
            got = svc.submit(g, H, CFG).result(timeout=120)
            s = svc.stats()["store"]
            svc.close()
        else:
            svc = _svc(store_path=path)
            first = svc.submit(g, H, CFG).result(timeout=120)
            svc.close()
            got = ref_svc.submit(jg, jh, jcfg).result(timeout=300)
            s = ref_svc.stats()["store"]
    finally:
        ref_svc.close()
    assert got.stats["result_cache"]["hit"] is True and s["hits"] == 1
    _same(got, first)
    _same(got, shared_map_direct(g, H, CFG, device="cpu"))


# ----------------------------------------------------- supervised worker mode

def test_worker_mode_clean_and_sigkill_recovery(tmp_path):
    """A clean worker-mode request equals the direct path; a worker
    SIGKILLed mid-request is restarted and the request re-dispatched — the
    Future still resolves, bit for bit."""
    g = _ring()
    inj = FaultInjector(fail_at={"worker_kill": (1,)})
    tr = InMemoryTracker()
    svc = _svc(workers=1, fault_injector=inj, tracker=tr,
               store_path=str(tmp_path / "store"),
               worker_kwargs={"restart_backoff_s": 0.01})
    try:
        clean = svc.submit(g, H, CFG).result(timeout=300)
        _same(clean, shared_map_direct(g, H, CFG, device="cpu"))
        assert clean.stats["backend"] == "xla"   # auto, resolved in the worker on the CPU

        cfg2 = SharedMapConfig(preset="fast", seed=7)
        killed = svc.submit(g, H, cfg2).result(timeout=300)
        _same(killed, shared_map_direct(g, H, cfg2, device="cpu"))
        s = svc.stats()
        assert s["workers"]["killed_injected"] == 1
        assert s["workers"]["crashes"] >= 1 and s["workers"]["restarts"] >= 1
        assert s["workers"]["redispatched"] >= 1
        assert s["store"]["writes"] == 2  # both results persisted
        assert any(e["name"] == "worker_crash" for e in tr.events)
    finally:
        svc.close()


# ------------------------------------------------------- shadow verification

def test_shadow_match_keeps_device_live():
    dcfg = SharedMapConfig(preset="fast", strategy="device")
    svc = _svc(shadow_verify_fraction=1.0)
    res = svc.submit(_ring(), H, dcfg).result(timeout=300)
    svc.close(wait=True)  # drains the fallback pool -> shadow job done
    s = svc.stats()
    assert res.stats.get("resident") is not False
    assert (s["shadow"]["sampled"], s["shadow"]["matched"], s["shadow"]["mismatched"]) == \
        (1, 1, 0)
    assert s["shadow"]["device_quarantined"] is False


def test_shadow_mismatch_quarantines_device(tmp_path, monkeypatch):
    """A host-mirror twin that disagrees: the service records the mismatch,
    evicts + quarantines the entry, and routes every later device request
    to the host path."""
    g = _ring()
    dcfg = SharedMapConfig(preset="fast", strategy="device")
    tr = InMemoryTracker()
    svc = _svc(shadow_verify_fraction=1.0, tracker=tr, store_path=str(tmp_path / "store"))
    orig = capi.shared_map_direct

    def lying(g_, h_, cfg_, checkpoint=None, resident=None, device=None):
        res = orig(g_, h_, cfg_, checkpoint=checkpoint, resident=resident, device=device)
        if resident is False:  # only the shadow twin lies
            res.pe_of = (res.pe_of + 1) % int(h_.k)
        return res

    monkeypatch.setattr(capi, "shared_map_direct", lying)
    try:
        svc.submit(g, H, dcfg).result(timeout=300)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not svc.stats()["shadow"]["mismatched"]:
            time.sleep(0.05)
        s = svc.stats()
        assert s["shadow"]["mismatched"] == 1 and s["shadow"]["device_quarantined"] is True
        assert s["store"]["quarantined"] == 1  # the lying entry is evicted
        assert any(e["name"] == "shadow_mismatch" for e in tr.events)
        monkeypatch.setattr(capi, "shared_map_direct", orig)
        later = svc.submit(g, H, SharedMapConfig(preset="fast", strategy="device",
                                                 seed=3)).result(timeout=300)
        assert later.stats.get("resident") is False
        assert svc.stats()["shadow"]["sampled"] == 1   # none while quarantined
    finally:
        svc.close()


def test_shadow_fraction_zero_never_samples():
    with _svc() as svc:
        svc.submit(_ring(), H, SharedMapConfig(preset="fast", strategy="device")).result(
            timeout=300)
    assert svc.stats()["shadow"]["sampled"] == 0
