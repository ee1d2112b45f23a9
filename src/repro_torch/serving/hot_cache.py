"""Frequency-based hot-row cache for quantized embedding tables.

Mirrors `repro/serving/hot_cache.py`: the hottest rows of an int8 table
are pinned dense in float32, bit-identical to their dequantized int8 rows,
so a cached lookup equals the uncached one and the cache only saves
bandwidth. Every cached op returns a `CacheStats` (hits, lookups).
Membership is `torch.searchsorted` over the ascending `hot_ids` plus an
equality probe.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedTensor, dequantize_rowwise

# empty-slot sentinel for invalidated hot rows: sorts after every real id
INVALID_ID = 2**31 - 1


class CacheStats(NamedTuple):
    hits: torch.Tensor  # () int32 — ids served from the hot set
    lookups: torch.Tensor  # () int32 — total valid (non-padding) ids

    @staticmethod
    def zero(device=None) -> "CacheStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return CacheStats(hits=z, lookups=z)

    def __add__(self, other: "CacheStats") -> "CacheStats":
        return CacheStats(hits=self.hits + other.hits,
                          lookups=self.lookups + other.lookups)

    def as_dict(self) -> dict:
        """Plain-int view ``{hits, lookups, hit_rate}``."""
        hits, lk = int(self.hits), int(self.lookups)
        return {"hits": hits, "lookups": lk,
                "hit_rate": hits / lk if lk else 0.0}


@dataclass(frozen=True)
class HotRowCache:
    """Top-K hot rows of one int8 table, pinned dense in f32.

    `hot_ids` is sorted ascending; `hot_rows[i]` is the exact dequantized
    image of table row `hot_ids[i]`.
    """

    hot_ids: torch.Tensor  # (K,) int32, sorted
    hot_rows: torch.Tensor  # (K, d) f32
    capacity: int = 0


def top_ids_by_freq(freqs, k: int, eligible=None) -> np.ndarray:
    """Rank row ids by (frequency desc, id asc) and return the top `k`.

    The ascending-id tie-break makes the pinned set deterministic; the
    chunked threshold select returns the exact lexsort answer in O(chunk)
    temporary memory. `eligible` (n,) bool excludes rows (the result may
    then be short).
    """
    freqs = np.asarray(freqs, np.int64)
    n = freqs.shape[0]
    k = min(int(k), n)
    if k <= 0:
        return np.zeros((0,), np.int32)
    elig = None if eligible is None else np.asarray(eligible, bool)
    chunk = 1 << 20

    def masked(lo, hi):
        c = freqs[lo:hi]
        if elig is None:
            return c
        return np.where(elig[lo:hi], c, np.int64(-1))

    pool = []  # per-chunk top-k values: the global top-k lives in here
    for lo in range(0, n, chunk):
        c = masked(lo, min(lo + chunk, n))
        m = c.shape[0]
        pool.append(np.partition(c, m - k)[m - k:].copy() if m > k
                    else np.array(c))
    pool = np.concatenate(pool)
    t = np.partition(pool, pool.shape[0] - k)[pool.shape[0] - k]

    gt, eq, n_eq = [], [], 0
    for lo in range(0, n, chunk):
        c = masked(lo, min(lo + chunk, n))
        gt.append(lo + np.flatnonzero(c > t))
        if n_eq < k:  # chunks ascend in id, so the first k suffice
            ids = lo + np.flatnonzero(c == t)
            eq.append(ids)
            n_eq += ids.shape[0]
    gt = np.concatenate(gt)  # at most k rows are strictly above the k-th
    order = np.lexsort((gt, -freqs[gt]))
    top = np.concatenate([gt[order], np.concatenate(eq)[: k - gt.shape[0]]])
    if elig is not None:
        top = top[elig[top] & (freqs[top] >= 0)]
    return top.astype(np.int32)


def build_hot_cache(table: QuantizedTensor, freqs=None,
                    capacity: int = 256) -> HotRowCache:
    """Pin the `capacity` most frequent rows of `table` (on its device).

    freqs: (n_rows,) lookup counts; None pins the lowest row ids.
    """
    n, d = table.values.shape
    dev = table.values.device
    capacity = min(int(capacity), n)
    if capacity <= 0:
        return HotRowCache(
            hot_ids=torch.zeros((0,), dtype=torch.int32, device=dev),
            hot_rows=torch.zeros((0, d), dtype=torch.float32, device=dev),
            capacity=0)
    if freqs is None:
        hot = np.arange(capacity, dtype=np.int32)
    else:
        freqs = np.asarray(freqs)
        if freqs.shape != (n,):
            raise ValueError(f"freqs {freqs.shape} for a {n}-row table")
        hot = np.sort(top_ids_by_freq(freqs, capacity))
    hot_ids = torch.from_numpy(hot).to(dev)
    rows = dequantize_rowwise(QuantizedTensor(
        values=table.values[hot_ids.long()],
        scales=table.scales[hot_ids.long()]))
    return HotRowCache(hot_ids=hot_ids, hot_rows=rows, capacity=capacity)


def pin_rows(table: QuantizedTensor, ids, capacity: int) -> HotRowCache:
    """Pin exactly `ids` (unique row ids) into a capacity-`capacity` cache.

    Slots beyond ``len(ids)`` are empty (`INVALID_ID` ids, zero rows): the
    live catalog's reference rebuild reproduces a churned cache's surviving
    hot set this way, so the cache counters stay comparable bit for bit.
    Host-side; the cache lands on the table's device.
    """
    d = int(table.values.shape[1])
    dev = table.values.device
    ids = np.sort(np.asarray(ids, np.int32).reshape(-1))
    capacity = max(int(capacity), 0)
    if len(ids) > capacity:
        raise ValueError(f"pin_rows: {len(ids)} ids exceed capacity "
                         f"{capacity}")
    hot_ids = np.full(capacity, INVALID_ID, np.int32)
    hot_ids[: len(ids)] = ids
    rows = torch.zeros((capacity, d), dtype=torch.float32, device=dev)
    if len(ids):
        sel = torch.from_numpy(ids.astype(np.int64)).to(dev)
        rows[: len(ids)] = dequantize_rowwise(QuantizedTensor(
            values=table.values[sel], scales=table.scales[sel]))
    return HotRowCache(hot_ids=torch.from_numpy(hot_ids).to(dev),
                       hot_rows=rows, capacity=capacity)


def invalidate_rows(cache: HotRowCache | None, ids) -> HotRowCache | None:
    """Evict `ids` from the hot set (live-catalog row invalidation).

    A touched row's pinned image is stale the moment its table row
    changes, so it leaves the hot set; every other row stays pinned.
    Evicted slots become `INVALID_ID` ids with zero rows, and `hot_ids` is
    re-sorted stably so the searchsorted probe still holds. Host-side; a
    cache that holds none of `ids` comes back unchanged (the same object).
    New tensors are built, so a bucket already queued on the old cache
    reads the old bits.
    """
    if cache is None or cache.capacity == 0:
        return cache
    ids = np.asarray(ids, np.int64).reshape(-1)
    hot = cache.hot_ids.cpu().numpy().copy()
    dead = np.isin(hot, ids)
    if not dead.any():
        return cache
    hot[dead] = INVALID_ID
    order = np.argsort(hot, kind="stable")
    dev = cache.hot_ids.device
    rows = cache.hot_rows.clone()
    rows[torch.from_numpy(np.nonzero(dead)[0]).to(dev)] = 0.0
    perm = torch.from_numpy(order).to(dev)
    return HotRowCache(hot_ids=torch.from_numpy(hot[order]).to(dev),
                       hot_rows=rows[perm], capacity=cache.capacity)


def _probe(cache: HotRowCache, ids: torch.Tensor):
    """ids (...,) -> (hit mask (...,), position into hot_rows (...,))."""
    pos = torch.searchsorted(cache.hot_ids, ids)
    pos = pos.clamp(0, cache.capacity - 1)
    hit = (cache.hot_ids[pos] == ids) & (ids >= 0)
    return hit, pos


def cached_rows(cache: HotRowCache | None, table: QuantizedTensor,
                ids: torch.Tensor):
    """Gather rows for `ids` (...,) -> ((..., d) f32, CacheStats).

    Hot ids come from the pinned f32 rows, cold ids from the int8 rows;
    -1 ids give zero rows and count as no lookup; ids past the table read
    its last row, as the reference's clamped gather does.
    """
    valid = ids >= 0
    safe = ids.clamp(0, table.values.shape[0] - 1).long()
    cold = table.values[safe].to(torch.float32) * table.scales[safe]
    lookups = valid.sum(dtype=torch.int32)
    if cache is None or cache.capacity == 0:
        rows = torch.where(valid[..., None], cold, 0.0)
        return rows, CacheStats(hits=torch.zeros_like(lookups),
                                lookups=lookups)
    hit, pos = _probe(cache, ids)
    rows = torch.where(hit[..., None], cache.hot_rows[pos], cold)
    rows = torch.where(valid[..., None], rows, 0.0)
    return rows, CacheStats(hits=hit.sum(dtype=torch.int32), lookups=lookups)


def cached_lookup(cache: HotRowCache | None, table: QuantizedTensor,
                  ids: torch.Tensor):
    """`cached_rows` under the name of `core.embedding.lookup`'s drop-in."""
    return cached_rows(cache, table, ids)


def pool_rows(rows: torch.Tensor, ids: torch.Tensor,
              weights: torch.Tensor | None = None,
              mode: str = "sum") -> torch.Tensor:
    """THE pooling reduction: (B, L, d) rows + (B, L) ids -> (B, d)."""
    valid = (ids >= 0).to(torch.float32)
    w = valid if weights is None else weights.to(torch.float32) * valid
    pooled = torch.einsum("bld,bl->bd", rows, w)
    if mode == "mean":
        count = valid.sum(-1, keepdim=True)
        pooled = pooled / count.clamp(min=1.0)
    return pooled


def cached_embedding_bag(
    cache: HotRowCache | None,
    table: QuantizedTensor,
    ids: torch.Tensor,  # (B, L) int32, -1 padded
    weights: torch.Tensor | None = None,
    mode: str = "sum",
):
    """`core.embedding.embedding_bag` through the hot cache ->
    ((B, d), CacheStats)."""
    rows, stats = cached_rows(cache, table, ids)  # (B, L, d)
    return pool_rows(rows, ids, weights, mode), stats
