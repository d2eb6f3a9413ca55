"""Crash-safe, content-addressed persistent result store (DESIGN.md §12).

The port's own copy of the JAX package's ``serve.store``: the entry format
is the same (``RST1``, schema 1), so for the same result both packages
write the same bytes and each reads the other's store.

A result cache in the process dies with it, so a restarted mapping service
re-pays every compute it had already done. This module is the durability
tier behind that cache:

* **Content-addressed** — entries are keyed by the request fingerprint
  (the mapping service's hash of the real CSR arrays, hierarchy and
  config), so a reload can only ever serve the bit-identical result the
  same request would recompute.
* **Crash-safe writes** — each entry is serialized to a private temp file
  and published with an atomic ``os.replace``: readers (including other
  processes sharing the directory) see either the complete entry or no
  entry, never a torn one. A crash mid-write leaves only a stale temp
  file, swept opportunistically.
* **Self-verifying entries** — every entry carries a 4-byte magic, a
  schema version, and a blake2b-128 checksum over the full body (header +
  payload). Truncated, bit-flipped, or wrong-version entries are detected
  on load, moved to a ``quarantine/`` subdirectory (never deleted — they
  are forensic evidence), counted in ``stats()["corrupt"]`` and NEVER
  returned to the caller: a corrupt store degrades to a cache miss, not to
  wrong answers.
* **Deterministic fault injection** — a ``repro_torch.faults.FaultInjector``
  checked at the ``store_write`` seam simulates a torn write (the entry is
  deliberately truncated mid-body but still atomically published), so the
  corruption-detection path is exercised end-to-end in tests without
  touching real disk failure machinery.

Entry format (version 1)::

    [0:4)   magic  b"RST1"
    [4:20)  blake2b-16 digest of body
    [20:)   body = u32 header_len | header JSON (utf-8) | pe_of raw bytes

The header JSON carries the schema version, the fingerprint, the graph
fingerprint (to rebuild the service's nearby-result index), dtype/shape of
``pe_of``, ``J``, and the compute ``stats`` dict. The checksum is verified
BEFORE any parsing, so corrupt bytes never reach the JSON or numpy layer.
"""
from __future__ import annotations

import json
import logging
import os
import struct
import threading

import numpy as np

from ..core.api import SharedMapResult
from ..faults import NULL_INJECTOR, FaultInjector

_MAGIC = b"RST1"
_DIGEST_SIZE = 16
_SCHEMA_VERSION = 1
_HDR = struct.Struct("<I")  # body prefix: header length

log = logging.getLogger(__name__)


def _blake(data: bytes) -> bytes:
    import hashlib
    return hashlib.blake2b(data, digest_size=_DIGEST_SIZE).digest()


def _json_default(o):
    """Stats dicts may carry numpy scalars/arrays; store plain values (the
    port's own ``stats`` hold plain Python values only)."""
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


class CorruptEntryError(ValueError):
    """An entry failed verification (bad magic/version/checksum/shape)."""


def encode_entry(fp: bytes, gfp: bytes, res: SharedMapResult) -> bytes:
    """Serialize one result into the self-verifying entry format."""
    pe = np.ascontiguousarray(np.asarray(res.pe_of))
    header = json.dumps({
        "v": _SCHEMA_VERSION,
        "fp": fp.hex(),
        "gfp": gfp.hex(),
        "dtype": str(pe.dtype),
        "shape": list(pe.shape),
        "J": float(res.J),
        "stats": res.stats,
    }, default=_json_default).encode()
    body = _HDR.pack(len(header)) + header + pe.tobytes()
    return _MAGIC + _blake(body) + body


def decode_entry(blob: bytes, fp: bytes) -> tuple[SharedMapResult, bytes]:
    """Verify + parse an entry blob; returns (result, graph fingerprint).

    Raises :class:`CorruptEntryError` on ANY inconsistency — truncation,
    bit flips, wrong magic, wrong schema version, or a fingerprint that
    does not match the file's name (a misfiled entry is as dangerous as a
    corrupt one: it would answer the wrong request).
    """
    base = len(_MAGIC) + _DIGEST_SIZE
    if len(blob) < base + _HDR.size:
        raise CorruptEntryError(f"entry truncated to {len(blob)} bytes")
    if blob[:len(_MAGIC)] != _MAGIC:
        raise CorruptEntryError(f"bad magic {blob[:len(_MAGIC)]!r}")
    digest = blob[len(_MAGIC):base]
    body = blob[base:]
    if _blake(body) != digest:
        raise CorruptEntryError("checksum mismatch (bit flip or torn write)")
    (hlen,) = _HDR.unpack_from(body)
    if len(body) < _HDR.size + hlen:
        raise CorruptEntryError("header truncated")
    try:
        header = json.loads(body[_HDR.size:_HDR.size + hlen])
    except ValueError as exc:  # checksum passed but JSON broken: impossible
        raise CorruptEntryError(f"unparseable header: {exc}") from exc
    if header.get("v") != _SCHEMA_VERSION:
        raise CorruptEntryError(f"schema version {header.get('v')!r} != "
                                f"{_SCHEMA_VERSION}")
    if header.get("fp") != fp.hex():
        raise CorruptEntryError("entry fingerprint does not match its key")
    dtype = np.dtype(header["dtype"])
    shape = tuple(int(s) for s in header["shape"])
    payload = body[_HDR.size + hlen:]
    expect = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
    if len(payload) != expect:
        raise CorruptEntryError(f"payload is {len(payload)} bytes, "
                                f"expected {expect}")
    pe = np.frombuffer(payload, dtype=dtype).reshape(shape).copy()
    res = SharedMapResult(pe_of=pe, J=float(header["J"]),
                          stats=dict(header["stats"]))
    return res, bytes.fromhex(header.get("gfp", ""))


class ResultStore:
    """Directory-backed crash-safe result store.

    One file per entry (``<fp-hex>.res``), atomic publication, checksum
    verification on every read, quarantine of anything that fails it.
    Thread-safe; multiple processes may share a directory (writes are
    atomic renames, reads never observe partial files).

    Parameters
    ----------
    path: store directory (created, along with ``quarantine/``).
    fault_injector: checked at the ``store_write`` seam — a fired fault
        publishes a deliberately TRUNCATED entry (a simulated torn write)
        instead of failing the put, so corruption detection is testable.
    """

    def __init__(self, path: str,
                 fault_injector: FaultInjector = NULL_INJECTOR):
        self.path = str(path)
        self.quarantine_dir = os.path.join(self.path, "quarantine")
        self._tmp_dir = os.path.join(self.path, "tmp")
        self.faults = fault_injector
        self._lock = threading.Lock()
        self._seq = 0
        self._stats = {"hits": 0, "misses": 0, "writes": 0, "write_errors": 0,
                       "corrupt": 0, "quarantined": 0, "bytes_written": 0,
                       "entries_on_open": 0}
        os.makedirs(self.path, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)
        os.makedirs(self._tmp_dir, exist_ok=True)
        self._sweep_tmp()
        self._stats["entries_on_open"] = len(self.keys())

    # ------------------------------------------------------------- paths

    def _entry_path(self, fp: bytes) -> str:
        return os.path.join(self.path, fp.hex() + ".res")

    def keys(self) -> list[bytes]:
        """Fingerprints of every published entry (no verification)."""
        out = []
        try:
            names = os.listdir(self.path)
        except OSError:
            return out
        for name in names:
            if name.endswith(".res"):
                try:
                    out.append(bytes.fromhex(name[:-4]))
                except ValueError:
                    pass  # foreign file; ignore
        return out

    def __len__(self) -> int:
        return len(self.keys())

    def _sweep_tmp(self) -> None:
        """Remove temp files orphaned by a crash mid-write: they were never
        published, so deleting them cannot lose a committed entry."""
        try:
            for name in os.listdir(self._tmp_dir):
                try:
                    os.unlink(os.path.join(self._tmp_dir, name))
                except OSError:
                    pass
        except OSError:
            pass

    # --------------------------------------------------------------- I/O

    def put(self, fp: bytes, gfp: bytes, res: SharedMapResult) -> bool:
        """Atomically publish ``res`` under ``fp``. Returns False (and
        counts ``write_errors``) on I/O failure — persistence is a tier,
        not a requirement: the serving path never fails on a store error."""
        try:
            blob = encode_entry(fp, gfp, res)
            try:
                self.faults.check("store_write")
            except BaseException:
                # injected torn write: publish a truncated body. Still an
                # ATOMIC rename — this models a crash between the write
                # syscalls of a non-atomic writer, which is exactly the
                # failure the checksum exists to catch.
                blob = blob[: max(len(blob) // 2, 1)]
            with self._lock:
                self._seq += 1
                tmp = os.path.join(self._tmp_dir,
                                   f"{fp.hex()}.{os.getpid()}.{self._seq}")
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._entry_path(fp))
            with self._lock:
                self._stats["writes"] += 1
                self._stats["bytes_written"] += len(blob)
            return True
        except Exception:
            log.debug("result store write failed", exc_info=True)
            with self._lock:
                self._stats["write_errors"] += 1
            return False

    def get(self, fp: bytes) -> tuple[SharedMapResult, bytes] | None:
        """Load + verify the entry for ``fp``; ``(result, gfp)`` or None.

        A corrupt entry is quarantined and reported as a miss — it is
        NEVER returned.
        """
        path = self._entry_path(fp)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            with self._lock:
                self._stats["misses"] += 1
            return None
        except OSError:
            log.debug("result store read failed", exc_info=True)
            with self._lock:
                self._stats["misses"] += 1
            return None
        try:
            res, gfp = decode_entry(blob, fp)
        except CorruptEntryError as exc:
            with self._lock:
                self._stats["corrupt"] += 1
            self.quarantine(fp, reason=str(exc))
            with self._lock:
                self._stats["misses"] += 1
            return None
        with self._lock:
            self._stats["hits"] += 1
        return res, gfp

    def quarantine(self, fp: bytes, reason: str = "") -> bool:
        """Move an entry out of the serving set into ``quarantine/`` (kept
        for forensics, with the reason alongside). Also the eviction path
        for entries the shadow verifier disowns."""
        src = self._entry_path(fp)
        dst = os.path.join(self.quarantine_dir, fp.hex() + ".res")
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            return False
        except OSError:
            try:  # cross-device or permission trouble: removal still
                os.unlink(src)  # guarantees it can never be served
            except OSError:
                return False
        try:
            with open(dst + ".reason", "w") as f:
                f.write(reason + "\n")
        except OSError:
            pass
        with self._lock:
            self._stats["quarantined"] += 1
        log.warning("result store quarantined %s: %s", fp.hex(), reason)
        return True

    def stats(self) -> dict:
        with self._lock:
            snap = dict(self._stats)
        snap["entries"] = len(self)
        return snap
