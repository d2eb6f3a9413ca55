"""The C library's ``powf``, bit for bit: a CUDA kernel and its numpy plain version.

The reference computes ``x ** float32(1 / d)`` for d >= 3 under XLA's jit on
the CPU, which calls the C library's ``powf`` (``core/hierarchy.py:_powf``).
That is glibc's (2.28 and later): log2(x) in float64 from a 16-entry table
and a degree-5 polynomial, times y, then 2^(y log2 x) in float64 from a
32-entry table and a degree-3 polynomial, rounded once to float32. It is not
correctly rounded: it differs from the correctly rounded result on about
0.06% of inputs, so neither torch's float32 ``pow`` nor any correctly rounded
routine gives its bits. This module reproduces the algorithm itself:

- ``powf_ref`` is the plain version, in numpy float64, with exact fused
  multiply-adds (:func:`fma_f64`) where glibc's x86_64 build fuses them
  (its ``powf`` is compiled with FMA contraction on a CPU that has it);
- ``powf_cuda`` launches ``csrc/powf.cu``, the same steps with
  ``__fma_rn``/``__dmul_rn``/``__dadd_rn``, the tables passed in from here.

``python -m repro_torch.kernels.powf`` holds the plain version against the C
library's ``powf`` (through ``ctypes``) for every float32 in [1, 8) at
d = 3, 4 and 5, and counts where the library and the correctly rounded value
lie apart.

Domain: ``0 < y < 1`` (the exponent 1/d); any float32 x (zero, subnormal,
negative, infinite and NaN x take glibc's special-case branch).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

# glibc's __powf_log2_data: (1/c, log2 c) for 16 subintervals of [0x3f330000, 2 x that)
LOG2_TAB = tuple(float.fromhex(s) for s in """
    0x1.661ec79f8f3bep+0 -0x1.efec65b963019p-2  0x1.571ed4aaf883dp+0 -0x1.b0b6832d4fca4p-2
    0x1.49539f0f010b0p+0 -0x1.7418b0a1fb77bp-2  0x1.3c995b0b80385p+0 -0x1.39de91a6dcf7bp-2
    0x1.30d190c8864a5p+0 -0x1.01d9bf3f2b631p-2  0x1.25e227b0b8ea0p+0 -0x1.97c1d1b3b7af0p-3
    0x1.1bb4a4a1a343fp+0 -0x1.2f9e393af3c9fp-3  0x1.12358f08ae5bap+0 -0x1.960cbbf788d5cp-4
    0x1.0953f419900a7p+0 -0x1.a6f9db6475fcep-5  0x1.0000000000000p+0  0x0.0p+0
    0x1.e608cfd9a47acp-1  0x1.338ca9f24f53dp-4  0x1.ca4b31f026aa0p-1  0x1.476a9543891bap-3
    0x1.b2036576afce6p-1  0x1.e840b4ac4e4d2p-3  0x1.9c2d163a1aa2dp-1  0x1.40645f0c6651cp-2
    0x1.886e6037841edp-1  0x1.88e9c2c1b9ff8p-2  0x1.767dcf5534862p-1  0x1.ce0a44eb17bccp-2
    """.split())
# its log2(1 + r) polynomial, highest power first
LOG2_POLY = tuple(float.fromhex(s) for s in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
# __exp2f_data: bits of 2^(i/32) minus (i << 47), and the 2^r polynomial
EXP2_TAB = tuple(int(s, 16) for s in """
    3ff0000000000000 3fefd9b0d3158574 3fefb5586cf9890f 3fef9301d0125b51
    3fef72b83c7d517b 3fef54873168b9aa 3fef387a6e756238 3fef1e9df51fdee1
    3fef06fe0a31b715 3feef1a7373aa9cb 3feedea64c123422 3feece086061892d
    3feebfdad5362a27 3feeb42b569d4f82 3feeab07dd485429 3feea47eb03a5585
    3feea09e667f3bcd 3fee9f75e8ec5f74 3feea11473eb0187 3feea589994cce13
    3feeace5422aa0db 3feeb737b0cdc5e5 3feec49182a3f090 3feed503b23e255d
    3feee89f995ad3ad 3feeff76f2fb5e47 3fef199bdd85529c 3fef3720dcef9069
    3fef5818dcfba487 3fef7c97337b9b5f 3fefa4afa2a490da 3fefd0765b6e4540
    """.split())
EXP2_POLY = tuple(float.fromhex(s) for s in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
OFF = 0x3F330000
SHIFT = float.fromhex("0x1.8p47")   # 0x1.8p52 / 32: x + SHIFT rounds x to k / 32

_ALL = np.concatenate([np.array(LOG2_TAB + LOG2_POLY),
                       np.array(EXP2_TAB, dtype=np.uint64).view(np.float64),
                       np.array(EXP2_POLY)])   # the kernel's table argument, 72 doubles
_DEVICE_TABLES: dict[torch.device, torch.Tensor] = {}


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma_f64(a, b, c):
    """``a * b + c`` in float64 with one rounding (numpy arrays).

    Boldo and Melquiond's emulation: the product split exactly
    (Veltkamp/Dekker), ``c`` added to its high part exactly, the two low
    parts added with rounding to odd, and one final rounding to nearest.
    Exact while nothing underflows, as for every value of ``powf_ref``.
    """
    a, b, c = (np.asarray(v, dtype=np.float64) for v in (a, b, c))
    uh = a * b
    t = 134217729.0 * a                    # 2^27 + 1
    ah = t - (t - a)
    al = a - ah
    t = 134217729.0 * b
    bh = t - (t - b)
    bl = b - bh
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    even = (v.view(np.int64) & 1) == 0
    v = np.where((e != 0) & even, np.nextafter(v, np.where(e > 0, np.inf, -np.inf)), v)
    return th + v


def powf_ref(x: np.ndarray, y: float) -> np.ndarray:
    """glibc's ``powf(x, y)`` for float32 ``x`` and ``0 < y < 1``, in numpy."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = float(np.float32(y))
    if not 0.0 < y < 1.0:
        raise ValueError(f"powf_ref: y must lie in (0, 1), got {y}")
    ix = x.view(np.uint32).copy()
    special = (ix - np.uint32(0x00800000)) >= np.uint32(0x7F800000 - 0x00800000)
    sub = special & (ix < np.uint32(0x00800000)) & (ix != 0)   # positive subnormal
    with np.errstate(invalid="ignore", over="ignore"):
        ix = np.where(sub, ((x * np.float32(2.0**23)).view(np.uint32) & np.uint32(0x7FFFFFFF))
                      - np.uint32(23 << 23), ix)
        # log2(x) = log1p(z/c - 1) / ln2 + log2(c) + k, with x = 2^k z
        tmp = ix - np.uint32(OFF)
        i = ((tmp >> np.uint32(19)) % np.uint32(16)).astype(np.intp)
        top = tmp & np.uint32(0xFF800000)
        z = (ix - top).view(np.float32).astype(np.float64)
        k = (top.view(np.int32) >> 23).astype(np.float64)
        tab = np.array(LOG2_TAB).reshape(16, 2)
        A = LOG2_POLY
        r = fma_f64(z, tab[i, 0], -1.0)
        y0 = tab[i, 1] + k
        r2 = r * r
        p1 = fma_f64(A[0], r, A[1])
        p2 = fma_f64(A[2], r, A[3])
        r4 = r2 * r2
        q = fma_f64(A[4], r, y0)
        q = fma_f64(p2, r2, q)
        logx = fma_f64(p1, r4, q)
        # 2^(y log2 x) = 2^(k/32) * 2^r, with r in [-1/64, 1/64]
        xd = y * logx
        kd = xd + SHIFT
        ki = kd.view(np.uint64)
        r = xd - (kd - SHIFT)
        s = (np.array(EXP2_TAB, dtype=np.uint64)[(ki % np.uint64(32)).astype(np.intp)]
             + (ki << np.uint64(47))).view(np.float64)
        C = EXP2_POLY
        zc = fma_f64(C[0], r, C[1])
        r2 = r * r
        out = fma_f64(C[2], r, 1.0)
        out = fma_f64(zc, r2, out)
        out = (out * s).astype(np.float32)
        # glibc's special cases for y in (0, 1), y not an integer: x * x for
        # +-0, +-inf and NaN; NaN for a finite negative x
        zin = (2 * x.view(np.uint32).astype(np.uint64) - 1) % 2**32 >= 2 * 0x7F800000 - 1
        out = np.where(zin, x * x, out)
        out = np.where(special & ~zin & (x < 0), np.float32(np.nan), out)
    return out.astype(np.float32)


def powf_cuda(x: torch.Tensor, y: float) -> torch.Tensor:
    """glibc's ``powf(x, y)`` elementwise on the card; f32 ``x``, ``0 < y < 1``."""
    _build.require_cuda("powf", x)
    _build.require_dtype("powf", x, torch.float32)
    y = float(np.float32(y))
    if not 0.0 < y < 1.0:
        raise ValueError(f"powf: y must lie in (0, 1), got {y}")
    tables = _DEVICE_TABLES.get(x.device)
    if tables is None:
        tables = _DEVICE_TABLES.setdefault(x.device, torch.from_numpy(_ALL).to(x.device))
    out = torch.empty_like(x)
    if x.numel():
        _build.launch("powf", "powf_f32", x.device, x.data_ptr(), out.data_ptr(),
                      tables.data_ptr(), x.numel(), y)
    return out


def near_midpoint(x: np.ndarray, y: float, tol: float = 2.0**-9) -> np.ndarray:
    """Mask of the float32 ``x`` (results in [2^-126, 2^128)) whose exact
    ``x ** y`` lies within ``tol`` of a float32 ulp of a rounding midpoint
    (judged from numpy's float64 power): the only inputs on which a powf
    whose float64 result errs by less than ``tol`` ulp can round otherwise
    than a correctly rounded one."""
    p = np.power(x.astype(np.float64), float(np.float32(y)))
    low = p.view(np.uint64) & np.uint64((1 << 29) - 1)   # bits below a float32 ulp
    return np.abs(low.astype(np.float64) - 2.0**28) < tol * 2.0**29


def _libm_powf():
    import ctypes
    import ctypes.util
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


def libm_powf(x: np.ndarray, y: float) -> np.ndarray:
    """The C library's ``powf`` on every element, one call each (ctypes)."""
    fn = _libm_powf()
    y = float(np.float32(y))
    return np.array([fn(v, y) for v in np.asarray(x, np.float32).tolist()], np.float32)


def _correctly_rounded(x: np.ndarray, y: float) -> np.ndarray:
    """float32 ``x ** y`` rounded once; near a midpoint, from 40 decimal digits."""
    from decimal import Decimal, getcontext
    getcontext().prec = 40
    out = np.power(x.astype(np.float64), float(np.float32(y))).astype(np.float32)
    yd = Decimal(float(np.float32(y)))
    for j in np.flatnonzero(near_midpoint(x, y, 2.0**-20)):
        exact = Decimal(float(x[j])) ** yd
        lo = np.float32(float(exact))
        hi = np.nextafter(lo, np.float32(np.inf) if Decimal(float(lo)) < exact
                          else np.float32(-np.inf))
        out[j] = lo if abs(Decimal(float(lo)) - exact) <= abs(Decimal(float(hi)) - exact) else hi
    return out


def _check_chunk(args):
    lo, hi, d = args
    x = np.arange(lo, hi, dtype=np.uint32).view(np.float32)
    y = float(np.float32(1.0 / d))
    lib = libm_powf(x, y)
    ref = powf_ref(x, y)
    cr = _correctly_rounded(x, y)
    apart = lib.view(np.uint32) != cr.view(np.uint32)
    return (int((ref.view(np.uint32) != lib.view(np.uint32)).sum()), int(apart.sum()),
            int((apart & ~near_midpoint(x, y)).sum()), int(near_midpoint(x, y).sum()))


def main() -> int:
    import argparse
    import time
    from multiprocessing import get_context
    ap = argparse.ArgumentParser(description="Hold powf_ref against the C library's "
                                 "powf for every float32 in [1, 8) at d = 3, 4, 5.")
    ap.add_argument("--procs", type=int, default=4)
    args = ap.parse_args()
    lo, hi = int(np.float32(1.0).view(np.uint32)), int(np.float32(8.0).view(np.uint32))
    step = 1 << 18
    for d in (3, 4, 5):
        t0 = time.perf_counter()
        chunks = [(a, min(a + step, hi), d) for a in range(lo, hi, step)]
        with get_context("spawn").Pool(args.procs) as pool:
            res = np.array(pool.map(_check_chunk, chunks)).sum(0)
        print(f"d={d}: {hi - lo} float32 in [1, 8); powf_ref != libm powf on {res[0]}; "
              f"libm != correctly rounded on {res[1]}, of which {res[2]} outside "
              f"near_midpoint (which holds {res[3]}); {time.perf_counter() - t0:.0f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
