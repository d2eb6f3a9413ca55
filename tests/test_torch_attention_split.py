"""Each model rank's share of an attention
(``repro_torch.models.attention._rank_share``) on the CPU without a world:
every rank's share runs in lock-step on one process
(``attention.ranks_in_turn``, the all-to-all done by hand).

* The units each rank attends and the column shards that come back, held
  bit for bit against the tensor split directly: evenly and unevenly in
  ``torch.chunk``'s order (ranks with fewer units, or none; column shards
  that cut a head), for q (several query heads a group) and k/v (one);
  and where there are fewer units than ranks, each unit's queries split
  into chunks over the ranks that share it.
* The shares' attention (RoPE, then ``_sdpa`` with a causal mask, in f64)
  put back together against the unsplit attention: from the projections'
  column shards (prefill), from replicated heads (decode on a replicated
  cache), by whole heads where both head counts divide the ranks, and
  against k/v of another length (cross-attention, no mask or RoPE).

The sharded step through this exchange is held against the JAX package in
``test_torch_moe_parallel.py``; ``chip_smoke.py`` phase 14 (e) runs the
same shares through the flash kernel on the card.
"""
import types

import pytest
import torch

from repro_torch.models.attention import _chunk_range, _gqa_sdpa, _rank_share, ranks_in_turn
from repro_torch.models.layers import apply_rope, rope_angles

S = 3


def _cfg(G, heads, Dh):
    return types.SimpleNamespace(num_heads=G * heads, num_kv_heads=G, head_dim=Dh)


def _cols(t, M, r):
    return t[:, :, slice(*_chunk_range(t.shape[2], M, r))]


@pytest.mark.parametrize("B,G,heads,Dh,M", [
    (4, 2, 2, 12, 4),      # the smoke (1, 4) mesh: q shards of one head, 2 units a rank
    (16, 8, 3, 8, 16),     # llama3.2-3b x train_4k's layout, narrow: 1.5 heads a shard
    (2, 8, 8, 4, 16),      # qwen2-72b x prefill_32k's: one unit a rank
    (16, 6, 1, 8, 16),     # whisper-tiny's: 6 heads, shards of 3/8 of a head
    (3, 2, 2, 6, 4),       # 6 units over 4 ranks: 2, 2, 2, 0
    (1, 3, 1, 6, 4),       # 3 units over 4 ranks; 18 columns: 5, 5, 5, 3
    (5, 3, 2, 5, 4),       # 15 units: 4, 4, 4, 3; 30 columns: 8, 8, 8, 6
])
def test_units_and_back(B, G, heads, Dh, M):
    W = heads * Dh
    q = torch.arange(B * S * G * W, dtype=torch.float64).reshape(B, S, G * W)
    k, v = (-torch.arange(B * S * G * Dh, dtype=torch.float64).reshape(B, S, G * Dh) - c
            for c in (1, 0.5))
    seen = {}

    def keep(m):
        def fn(qs, ks, vs):
            seen[m] = (qs, ks, vs)
            return qs
        return fn

    back = ranks_in_turn([_rank_share(_cfg(G, heads, Dh), keep(m), _cols(q, M, m),
                                      _cols(k, M, m), _cols(v, M, m), kinds=("cols",) * 3,
                                      rope=None, M=M, m=m) for m in range(M)])
    for m in range(M):
        lo, hi = _chunk_range(B * G, M, m)
        if hi == lo:
            assert m not in seen, m          # a rank without units attends nothing
        for got, t, h in zip(seen.get(m, ()), (q, k, v), (heads, 1, 1)):
            want = t.reshape(B, S, G, h * Dh).permute(0, 2, 1, 3).reshape(B * G, S, h, Dh)
            assert torch.equal(got, want[lo:hi]), m
        assert torch.equal(back[m], _cols(q, M, m)), m


def test_query_split_units_and_back():
    """Fewer units than ranks (qwen2-72b x prefill_32k's layout on pod2: one
    batch row, 8 kv groups, 16 model ranks): each unit goes to M / units
    ranks, each attending its chunk of the queries (and of the mask's
    rows) against the unit's whole k/v; the chunks come back in order."""
    B, G, heads, Dh, M, Sq = 1, 2, 2, 12, 4, 6
    W = heads * Dh
    q = torch.arange(B * Sq * G * W, dtype=torch.float64).reshape(B, Sq, G * W)
    k, v = (-torch.arange(B * Sq * G * Dh, dtype=torch.float64).reshape(B, Sq, G * Dh) - c
            for c in (1, 0.5))
    mask = torch.arange(Sq * Sq).reshape(1, Sq, Sq)
    seen = {}

    def keep(m):
        def fn(qs, ks, vs, ms):
            seen[m] = (qs, ks, vs, ms)
            return qs
        return fn

    back = ranks_in_turn([_rank_share(_cfg(G, heads, Dh), keep(m), _cols(q, M, m),
                                      _cols(k, M, m), _cols(v, M, m), mask,
                                      kinds=("cols",) * 3, rope=None, M=M, m=m)
                          for m in range(M)])
    for m in range(M):
        u, rows = m // 2, slice(m % 2 * Sq // 2, (m % 2 + 1) * Sq // 2)
        for got, t, h in zip(seen[m], (q, k, v), (heads, 1, 1)):
            want = t.reshape(B, Sq, G, h * Dh).permute(0, 2, 1, 3).reshape(B * G, Sq, h, Dh)
            want = want[u:u + 1]
            assert torch.equal(got, want[:, rows] if h == heads else want), m
        assert torch.equal(seen[m][3], mask[:, rows]), m
        assert torch.equal(back[m], _cols(q, M, m)), m


@pytest.mark.parametrize("B,G,heads,Dh,M,kind,Sq", [
    (4, 2, 2, 8, 4, "cols", S),     # units from column shards (prefill)
    (3, 2, 3, 8, 4, "cols", S),     # 6 units over 4 ranks, a rank with none
    (3, 2, 3, 8, 4, "rep", S),      # units cut from replicated heads (decode)
    (2, 4, 2, 8, 4, "cols", S),     # whole heads: 8 query and 4 kv heads on 4 ranks
    (3, 2, 3, 8, 4, "cross", S),    # cross-attention: k/v of 5 positions, q of 3
    (1, 2, 3, 8, 4, "cols", 4),     # 2 units over 4 ranks: 2 query chunks a unit
    (1, 1, 3, 8, 4, "cols", 4),     # 1 unit over 4 ranks: a query each
    (1, 2, 3, 8, 4, "rep", 4),      # the chunks cut from replicated heads
    (1, 2, 3, 8, 4, "cross", 4),    # and against k/v of 5 positions
])
def test_shares_equal_the_whole_attention(B, G, heads, Dh, M, kind, Sq):
    cfg = _cfg(G, heads, Dh)
    S = Sq
    T = 5 if kind == "cross" else S
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, G * heads * Dh, generator=g, dtype=torch.float64)
    k, v = (torch.randn(B, T, G * Dh, generator=g, dtype=torch.float64) for _ in range(2))
    if kind == "cross":
        rope, mask = None, torch.ones(1, S, T, dtype=torch.bool)
    else:
        rope = rope_angles(torch.arange(S)[None, :], Dh, 10_000.0)
        mask = (torch.arange(S)[None, :] <= torch.arange(S)[:, None])[None]

    def local(t, m):
        if kind == "rep":
            return t.reshape(B, t.shape[1], -1, Dh)
        return _cols(t, M, m)

    back = ranks_in_turn([_rank_share(cfg, lambda *a: _gqa_sdpa(cfg, False, *a), local(q, m),
                                      local(k, m), local(v, m), mask,
                                      kinds=("rep" if kind == "rep" else "cols",) * 3,
                                      rope=rope, M=M, m=m) for m in range(M)])
    qh, kh, vh = (t.reshape(B, t.shape[1], -1, Dh) for t in (q, k, v))
    if rope is not None:
        qh, kh = apply_rope(qh, *rope), apply_rope(kh, *rope)
    want = _gqa_sdpa(cfg, False, qh, kh, vh, mask)
    torch.testing.assert_close(torch.cat(back, dim=2), want.reshape(B, S, -1), rtol=1e-12,
                               atol=1e-12)
