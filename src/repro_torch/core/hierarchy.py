"""Hardware hierarchy: H = a_1 : ... : a_l, D = d_1 : ... : d_l.

The mixed-radix bit-label PE distance (O(1) distance queries) and the
paper's adaptive imbalance (Lemma 5.1). ``a_1`` is the innermost level and
``a_l`` the outermost; a PE id is the mixed-radix number whose most
significant digit is the island, so the top-down multisection's block
indices concatenate to exactly this id (identity mapping).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    a: tuple[int, ...]    # a_1 .. a_l (innermost first)
    d: tuple[float, ...]  # d_1 .. d_l (distance when the highest differing level is i)

    def __post_init__(self):
        if len(self.a) != len(self.d):
            raise ValueError("H and D must have equal length")
        if any(x < 1 for x in self.a):
            raise ValueError("hierarchy factors must be >= 1")

    @property
    def l(self) -> int:
        return len(self.a)

    @property
    def k(self) -> int:
        return math.prod(self.a)

    @property
    def strides(self) -> tuple[int, ...]:
        """strides[i] = number of PEs inside one level-i group = a_1*...*a_i."""
        return tuple(math.prod(self.a[: i + 1]) for i in range(self.l))

    def digits(self, pe: np.ndarray) -> np.ndarray:
        """Mixed-radix digits of PE ids, innermost first: [*, l] (host numpy)."""
        pe = np.asarray(pe)
        out = np.zeros(pe.shape + (self.l,), np.int64)
        rest = pe.copy()
        for i, ai in enumerate(self.a):
            out[..., i] = rest % ai
            rest //= ai
        return out

    def distance_table(self) -> np.ndarray:
        """[k, k] float64 distance matrix D (host numpy; for the mapping
        phase's dense routines and tests)."""
        dig = self.digits(np.arange(self.k))                  # [k, l]
        diff = dig[:, None, :] != dig[None, :, :]             # [k, k, l]
        lvl = np.where(diff.any(-1), self.l - 1 - np.argmax(diff[:, :, ::-1], axis=-1), -1)
        dvec = np.asarray(self.d)
        return np.where(lvl >= 0, dvec[np.clip(lvl, 0, self.l - 1)], 0.0)

    def __str__(self):
        return "H=" + ":".join(map(str, self.a)) + " D=" + ":".join(f"{x:g}" for x in self.d)


def _tables(h: Hierarchy, device) -> tuple[torch.Tensor, torch.Tensor]:
    g_below = torch.tensor((1,) + h.strides[:-1], dtype=torch.int32, device=device)
    dvec = torch.tensor(h.d, dtype=torch.float32, device=device)
    return g_below, dvec


def pe_distance(h: Hierarchy, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Vectorized O(1) PE distance: ``d_i`` with ``i`` the number of group
    levels at which ``x`` and ``y`` differ (0 when ``x == y``)."""
    g_below, dvec = _tables(h, x.device)
    diff = (x[..., None] // g_below) != (y[..., None] // g_below)
    lvl = diff.sum(dim=-1, dtype=torch.int32)
    safe = (lvl - 1).clamp(0, h.l - 1)
    return torch.where(lvl > 0, dvec[safe], torch.zeros((), device=x.device))


def mapping_cost(h: Hierarchy, rows, cols, ewgt, pe_of, emask) -> torch.Tensor:
    """J(C, D, Pi) over directed CSR arrays (each undirected edge twice)."""
    d = pe_distance(h, pe_of[rows], pe_of[cols])
    return torch.sum(torch.where(emask, ewgt * d, torch.zeros((), device=d.device))) / 2.0


def adaptive_epsilon(eps: float, total_weight: float, sub_weight: float,
                     k: int, k_sub: int, depth: int) -> float:
    """Lemma 5.1: eps' = ((1+eps) * k' c(V) / (k c(V')))^(1/d) - 1, >= 0.

    Host float, which is what the bucket strategy uses.
    """
    if depth <= 0:
        return eps
    ratio = (1.0 + eps) * (k_sub * total_weight) / (k * max(sub_weight, 1e-12))
    return max(ratio ** (1.0 / depth) - 1.0, 0.0)


def _powf(x: torch.Tensor, depth: int) -> torch.Tensor:
    """``x ** float32(1 / depth)`` in float32, rounded as the reference's
    XLA program rounds it on the CPU.

    XLA rewrites a power of 1 to ``x`` and of 0.5 to a correctly rounded
    ``sqrt``, and calls the C library's ``powf`` for any other exponent;
    torch's own float32 ``pow`` and, on the CPU, its float32 ``sqrt`` round
    differently in a few cases in a thousand (ROADMAP.md, Queue 3). The
    port takes the square root in float64 (exact before the one rounding
    to float32), and reproduces the C library's ``powf`` bit for bit with
    ``kernels.ops.powf`` (its numpy plain version on the CPU, a kernel on
    the card), so that the ``device`` strategy computes its eps on the
    card without fetching weights and still matches the reference.
    """
    if depth == 1:
        return x
    if depth == 2:
        return torch.sqrt(x.double()).float()
    e = float(torch.tensor(1.0 / depth, dtype=torch.float32))
    return kops.powf(x.contiguous(), e)


def adaptive_epsilon_tensor(eps: float, total_weight: torch.Tensor,
                            sub_weight: torch.Tensor, k: int, k_sub: int,
                            depth: int) -> torch.Tensor:
    """Lemma 5.1 in float32 over [B] subgraph weights, on their device (the
    reference's ``adaptive_epsilon_jnp``): the ``device`` strategy computes
    every level's eps without fetching the weights. Its host twin runs this
    same function on the same device, so both get the same eps bits; for
    integer vertex weights below 2^24 the inputs themselves are exact.
    """
    dev = sub_weight.device
    if depth <= 0:
        return torch.full(sub_weight.shape, eps, dtype=torch.float32, device=dev)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    ratio = ((f32(1.0 + eps) * (f32(k_sub) * total_weight))
             / (f32(k) * torch.clamp(sub_weight, min=f32(1e-12))))
    return torch.clamp(_powf(ratio, depth) - 1.0, min=0.0)


def parse_hierarchy(hs: str, ds: str) -> Hierarchy:
    """Parse 'a1:a2:a3' / 'd1:d2:d3' strings (paper notation)."""
    return Hierarchy(a=tuple(int(x) for x in hs.split(":")),
                     d=tuple(float(x) for x in ds.split(":")))


def tpu_v5e_hierarchy(multi_pod: bool = False) -> Hierarchy:
    """The production meshes of this repo as process-mapping hierarchies.

    Single pod : 16 chips/rack x 16 racks      -> H = 16:16,   D = 1:10
    Multi pod  : ... x 2 pods (DCN)            -> H = 16:16:2, D = 1:10:100
    (innermost-first, per paper convention).
    """
    if multi_pod:
        return Hierarchy(a=(16, 16, 2), d=(1.0, 10.0, 100.0))
    return Hierarchy(a=(16, 16), d=(1.0, 10.0))
