"""Plain PyTorch versions of the port's kernels.

They mirror `repro/kernels/ref.py` op for op: the CPU tests run them
against the JAX reference, a CPU tensor takes them in `kernels/ops.py`, and
on the card they are what each CUDA kernel is held against. Signatures are
int32 tensors holding the uint32 bits; PyTorch has no popcount and no
uint32 shift on the CPU, so the popcount is a bit trick on int64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.streaming_nns import (
    BIG_DIST,
    big_key,
    merge_candidate_buffers,
    pack_key,
    superblock_rows,
    unpack_key,
)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor -> int32 counts."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


class SideTable(NamedTuple):
    """Rows that override a pool segment's table: the live catalog's delta
    shard (`serving/catalog.py`) or the tiered catalog's per-batch overlay
    (`serving/tiered.py`). `ids` ascend, padded with `EMPTY_ID`."""

    ids: torch.Tensor  # (D,) int32, ascending, EMPTY_ID padding
    values: torch.Tensor  # (D, d) int8
    scales: torch.Tensor  # (D, 1) f32


class PoolSegment(NamedTuple):
    """One table of a grouped embedding pool (`grouped_pool_ref`, and the
    kernel's segment behind `kernels/ops.py:grouped_pool`).

    mode: "sum" or "mean" pools each (B, L) bag of ids to one row; "rows"
    gives every id of a (B, N) array its own row, (B, N, d). hot_ids /
    hot_rows: the table's hot set (sorted ids, pinned f32 rows, as a
    `HotRowCache` holds them), or None. counted: the segment's hits and
    lookups go to the stage's counters. masked: the batch's `valid` mask
    applies (a padding row counts no lookup and reads zeros). column: the
    first of the segment's d columns in each output row. side: a
    `SideTable` whose rows take precedence (`pool_slots`), or None; a
    segment with a side table may have no base rows (values (0, d)).
    """

    values: torch.Tensor  # (n, d) int8
    scales: torch.Tensor  # (n, 1) f32
    mode: str = "sum"
    column: int = 0
    hot_ids: torch.Tensor | None = None  # (K,) int32, ascending
    hot_rows: torch.Tensor | None = None  # (K, d) f32
    counted: bool = False
    masked: bool = True
    side: SideTable | None = None


POOL_MODES = ("sum", "mean", "rows")


def pool_slots(seg: PoolSegment, ids: torch.Tensor,
               weights: torch.Tensor | None = None):
    """One segment's (R, L) slots -> ((R, d) f32, hits, lookups).

    The kernel's arithmetic: a slot's row is the pinned f32 row on a hit
    (the hot cache's `_probe`: lower-bound search clamped to the capacity,
    hit iff the id is there and >= 0), else `value * scale` of the clamped
    id. With a side table (`seg.side`, non-empty), a side-table hit (the
    same search on its ids) reads `value * scale` of that slot instead, and
    a miss at or past the table's n rows reads zeros (`delta_cached_rows`);
    hits still count hot-set hits only. Each term is `row * w`, summed slot
    by slot from 0 with padding slots (id < 0) adding nothing; `mean`
    divides by max(count, 1).
    """
    n, d = seg.values.shape
    valid = ids >= 0
    if n > 0:
        safe = ids.clamp(0, n - 1).long()
        rows = seg.values[safe].to(torch.float32) * seg.scales[safe]
    else:
        rows = torch.zeros(ids.shape + (d,), dtype=torch.float32,
                           device=ids.device)
    hits = torch.zeros((), dtype=torch.int32, device=ids.device)
    if seg.hot_ids is not None and seg.hot_ids.shape[0] > 0:
        pos = torch.searchsorted(seg.hot_ids, ids).clamp(
            0, seg.hot_ids.shape[0] - 1)
        hit = (seg.hot_ids[pos] == ids) & valid
        rows = torch.where(hit[..., None], seg.hot_rows[pos], rows)
        hits = hit.sum(dtype=torch.int32)
    side = seg.side
    if side is not None and side.ids.shape[0] > 0:
        spos = torch.searchsorted(side.ids, ids).clamp(
            0, side.ids.shape[0] - 1)
        shit = (side.ids[spos] == ids) & valid
        srows = side.values[spos].to(torch.float32) * side.scales[spos]
        rows = torch.where(shit[..., None], srows,
                           torch.where((ids < n)[..., None], rows, 0.0))
    acc = torch.zeros((ids.shape[0], d), dtype=torch.float32,
                      device=ids.device)
    for l in range(ids.shape[1]):
        term = rows[:, l]
        if weights is not None:
            term = term * weights[:, l:l + 1]
        acc = acc + torch.where(valid[:, l:l + 1], term, 0.0)
    if seg.mode == "mean":
        count = valid.sum(-1, keepdim=True, dtype=torch.int32)
        acc = acc / count.clamp(min=1).to(torch.float32)
    return acc, hits, valid.sum(dtype=torch.int32)


def grouped_pool_ref(segments, ids, outs, valid=None, weights=None,
                     sides=None):
    """Plain grouped embedding pool: segment s pools `ids[s]` (with
    `weights[s]`, if given) into columns [column, column + d) of each row
    of `outs[s]`, in place. `sides` (None, or a side table or None a
    segment) replaces the segments' own side tables for this call. Returns
    the (2,) int32 [hits, lookups] summed over the counted segments, or
    None if none is counted."""
    counts = None
    if any(seg.counted for seg in segments):
        counts = torch.zeros(2, dtype=torch.int32, device=ids[0].device)
    for s, seg in enumerate(segments):
        if sides is not None and sides[s] is not None:
            seg = seg._replace(side=sides[s])
        x = ids[s]
        if valid is not None and seg.masked:
            x = torch.where(valid[:, None], x, -1)
        w = None if weights is None else weights[s]
        if seg.mode == "rows":
            x = x.reshape(-1, 1)
            w = None if w is None else w.reshape(-1, 1)
        pooled, hits, lookups = pool_slots(seg, x, w)
        out = outs[s]
        d = seg.values.shape[1]
        out.view(-1, out.shape[-1])[:, seg.column:seg.column + d] = pooled
        if seg.counted:
            counts += torch.stack([hits, lookups])
    return counts


def embedding_pool_ref(
    table_values: torch.Tensor,  # (n, d) int8
    table_scales: torch.Tensor,  # (n, 1) f32
    ids: torch.Tensor,  # (B, L) int32, -1 = padding
    weights: torch.Tensor | None = None,  # (B, L) f32
) -> torch.Tensor:
    """Fused int8 dequant-gather-pool -> (B, d) f32: one "sum" segment."""
    out = torch.empty((ids.shape[0], table_values.shape[1]),
                      dtype=torch.float32, device=ids.device)
    grouped_pool_ref([PoolSegment(table_values, table_scales)], [ids], [out],
                     weights=None if weights is None else [weights])
    return out


def hamming_distance_ref(queries: torch.Tensor,
                         db: torch.Tensor) -> torch.Tensor:
    """queries (q, w), db (n, w) int32 signatures -> (q, n) int32."""
    x = queries[:, None, :] ^ db[None, :, :]
    return popcount32(x).sum(-1, dtype=torch.int32)


def streaming_nns_ref(
    queries: torch.Tensor,  # (q, w) int32
    db: torch.Tensor,  # (n, w) int32
    radius: int,
    max_candidates: int,
    *,
    scan_block: int = 4096,
    n_valid=None,
    superblock: int | None = None,
    db_mask: torch.Tensor | None = None,  # (n,) bool — False never matches
    prune_blocks: torch.Tensor | None = None,  # (q, nb) bool — True = skip
    prune_block_rows: int | None = None,
):
    """Chunked streaming NNS, O(q * (K + scan_block)) memory.

    Returns (indices, distances, counts): the `max_candidates` nearest
    matches per query sorted by (distance, index), padded (-1, BIG_DIST),
    and the count of all matches. Candidates are packed int32 keys within
    a superblock; each chunk's keys merge into the running buffer by one
    top-K (keys are unique, so only the sentinels tie, and they are equal
    values). A chunk every query prunes is skipped, as the reference's
    `lax.cond` does; rows past the summary's coverage always scan.
    """
    q, words = queries.shape
    n = db.shape[0]
    dev = queries.device
    big = big_key(words)
    sb_rows = superblock_rows(words, superblock=superblock)
    limit = n if n_valid is None else max(0, min(int(n_valid), n))

    row_needed = None
    if prune_blocks is not None:
        needed_b = (~prune_blocks).any(dim=0)
        row_needed = needed_b.repeat_interleave(int(prune_block_rows))
        if row_needed.shape[0] < n:
            row_needed = torch.cat([row_needed, torch.ones(
                n - row_needed.shape[0], dtype=torch.bool, device=dev)])
        row_needed = row_needed[:n]

    all_idx, all_dist = [], []
    counts = torch.zeros((q,), dtype=torch.int32, device=dev)
    for off in range(0, max(n, 1), sb_rows):
        n_s = min(sb_rows, n - off) if n else 0
        block = max(1, min(scan_block, n_s))
        keys = torch.full((q, max_candidates), big, dtype=torch.int32,
                          device=dev)
        for lo in range(0, max(n_s, 1), block):
            hi = min(lo + block, n_s)
            rows = slice(off + lo, off + hi)
            if hi <= lo or (row_needed is not None
                            and not bool(row_needed[rows].any())):
                continue
            d = hamming_distance_ref(queries, db[rows])
            lidx = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            within = (d <= radius) & (lidx + off < limit)[None, :]
            if db_mask is not None:
                within &= db_mask[rows][None, :]
            counts += within.sum(-1, dtype=torch.int32)
            new = torch.where(within, pack_key(d, lidx[None, :], words),
                              big).to(torch.int32)
            merged = torch.cat([keys, new], dim=1)
            keys = torch.topk(merged, max_candidates, dim=1, largest=False,
                              sorted=True).values
        dist, local = unpack_key(keys, words)
        valid = keys < big
        all_idx.append(torch.where(valid, local + off, -1))
        all_dist.append(torch.where(valid, dist, BIG_DIST))
    if len(all_idx) == 1:
        return all_idx[0], all_dist[0], counts
    indices, distances = merge_candidate_buffers(
        torch.cat(all_idx, dim=1), torch.cat(all_dist, dim=1),
        max_candidates)
    return indices, distances, counts


# ---------------------------------------------------------------------------
# int8 matmul (the iMARS crossbar MVM analogue)
# ---------------------------------------------------------------------------
def int8_matmul_ref(
    x: torch.Tensor,  # (m, k) int8
    w: torch.Tensor,  # (k, n) int8
    x_scale: torch.Tensor,  # (m, 1) f32
    w_scale: torch.Tensor,  # (1, n) f32
) -> torch.Tensor:
    """int8 x int8 product dequantized -> (m, n) f32.

    cuBLAS has no int32 GEMM, so the exact integer accumulator comes from a
    float64 product: every partial sum is an integer below k * 128**2,
    exact while that is under 2**53. Cast to float32, then
    `(acc * x_scale) * w_scale`, two rounded multiplies in the reference's
    order (`acc.astype(f32) * x_scale * w_scale`).
    """
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    return (acc.to(torch.float32) * x_scale) * w_scale


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
NEG_INF = -1e30  # the flash kernel's mask value


def attention_ref(q, k, v, *, causal=True, scale=None, q_offset=0):
    """Full-materialization softmax attention (oracle), (b, h, s, d)."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def blocked_attention_ref(q, k, v, *, causal=True, scale=None, q_offset=0,
                          block_k=1024):
    """Online-softmax attention over kv blocks of `block_k`, (b, h, s, d).

    The reference's CPU path for `ops.flash_attention`: f32 inside, -inf
    masking with the rows that have no valid key yet guarded.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d**-0.5 if scale is None else scale
    qf = q.float() * scale
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for lo in range(0, sk, block_k):
        kb = k[:, :, lo:lo + block_k].float()
        vb = v[:, :, lo:lo + block_k].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        cols = lo + torch.arange(kb.shape[2], device=q.device)[None, :]
        mask = cols <= rows if causal else torch.ones_like(cols, dtype=bool)
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, scale=None, q_offset=0):
    """The flash kernel's function on (bh, sq, d) x (bh, sk, d), one block.

    Scores `(q . k) * scale` in f32; masked scores are -1e30 and their
    probabilities 0; the normalizer is clamped at 1e-30 — so a row with no
    valid key gives 0, not NaN, as `repro`'s `_flash_kernel` does. Returns
    q's dtype.
    """
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = torch.arange(sk, device=q.device)[None, :] <= rows
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("bqk,bkd->bqd", p, v.float()) / l).to(q.dtype)


def decode_attention_ref(q, k, v, length_mask=None, scale=None):
    """One query position against a cache (oracle): q (b, h, 1, d), k and
    v (b, h, s, d), `length_mask` (b, s) bool marking the valid cache
    slots (others get no weight; a row with none is NaN, as in the
    reference). f32 inside; returns q's dtype."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if length_mask is not None:
        s = torch.where(length_mask[:, None, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
