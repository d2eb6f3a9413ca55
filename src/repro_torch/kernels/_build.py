"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

At first use, every source under ``csrc/`` is compiled by its own ``nvcc``
process (all started together) into an object file, and the objects are
linked into ONE shared library with a plain C interface, loaded with
``ctypes``. Nothing is compiled or loaded at import time, so the CPU tests
import every module of the package without ``nvcc``.

The library is cached under ``_build/`` next to this file (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads straight away.

Every kernel entry point has the signature ``int fn(<pointers>, <ints>,
cudaStream_t)``: pointers and the stream travel as ``c_void_p`` (a
``c_int`` would cut a 64-bit pointer), and the return value is the
``cudaError_t`` of the launch, which the wrapper turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: nvcc contracts no a*b+c into an FMA on its own; the one FMA
# the bitwise contract needs (hem_propose's score) is written out with
# __fmaf_rn, the way XLA fuses it in the reference. The flash-attention
# kernel writes its multiply-adds as fmaf for the same reason.
# -Xptxas=-v: each kernel's registers, shared memory and spills, kept in
# the build log beside the library (``ptxas_report``).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v"]

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else (chip_smoke.py resets and reads them).
LAUNCHES: dict[str, int] = {"gather_rows": 0, "hem_propose": 0,
                            "contract_edges": 0, "mapcost": 0, "lp_gain": 0,
                            "flash_attention": 0, "powf": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (src, idx, out, S, total, stream)
    "gather_rows_u32": [_P, _P, _P, _I, ctypes.c_longlong, _P],
    # (adj, adw, jit, matched, prop, N, DEG, stream)
    "hem_propose_f32": [_P, _P, _P, _P, _P, _I, _I, _P],
    # (cand, candw, nbr, w, cnt, N, D2, sent, stream)
    "contract_edges_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (rows, cols, ewgt, pe, g_below, dvec, scratch, arrived, M, N, l, blocks, stream)
    "mapcost_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (adj, adw, part, conn, best, gain, N, DEG, k, R, stream)
    "lp_gain_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (q, k, v, o, B, S, H, Hkv, D, scale, causal, window, stream)
    "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    # (D) -> dynamic shared memory bytes of one block
    "flash_attention_bf16_smem": [_I],
    # (x, out, tables, n, y, stream)
    "powf_f32": [_P, _P, _P, _I, ctypes.c_float, _P],
}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()   # the queue strategy launches from several threads
BUILD_SECONDS: float | None = None


def reset_launches() -> None:
    with _COUNT_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs: list[Path]) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library; returns its path."""
    global BUILD_SECONDS
    srcs = _sources()
    out = BUILD_DIR / f"librepro_torch_{_digest(srcs)}.so"
    if out.exists():
        BUILD_SECONDS = 0.0
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        bad = [(s.name, log) for s, p, log in zip(srcs, procs, logs) if p.returncode]
        if bad:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"--- {n}\n{log}" for n, log in bad))
        log_tmp = Path(tmp) / "build.log"
        log_tmp.write_text("".join(f"--- {s.name}\n{log}" for s, log in zip(srcs, logs)))
        lib_tmp = Path(tmp) / out.name
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                              "-o", str(lib_tmp)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(lib_tmp, out)  # atomic publish: concurrent builds agree
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def ptxas_report(source: str) -> list[str]:
    """ptxas's lines for the kernels of ``csrc/<source>`` from the build log
    of the current library (each entry, its registers, spills and shared
    memory, and any warning); builds the library first if needed."""
    lines, keep = [], False
    for line in build().with_suffix(".log").read_text().splitlines():
        if line.startswith("--- "):
            keep = line[4:] == source
        elif keep and any(w in line for w in ("Compiling entry", "spill", "Used", "arning")):
            lines.append(line.strip())
    return lines


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call a C entry point on ``device``'s current stream; raise on a CUDA
    error returned by the launch."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: cudaError {err}")
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every kernel input must be a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def require_dtype(name: str, t: torch.Tensor, *dtypes: torch.dtype) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected dtype in {dtypes}, got {t.dtype}")
