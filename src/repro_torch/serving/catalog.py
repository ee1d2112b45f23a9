"""Delta-aware row resolution (mirrors `repro/serving/catalog.py:116-165`).

Only the three functions the serve path calls. A frozen engine passes
`delta=None`, and they reduce to the hot-cache paths; `delta_rows` keeps
the reference's probe for an object with sorted `ids`, `values`, `scales`
and `capacity` (the live catalog, still to be ported).
"""
from __future__ import annotations

import torch

from repro_torch.serving.hot_cache import cached_rows, pool_rows


def delta_rows(delta, ids: torch.Tensor):
    """ids (...,) -> (hit mask (...,), dequantized rows (..., d) f32)."""
    pos = torch.searchsorted(delta.ids, ids).clamp(0, delta.capacity - 1)
    hit = (delta.ids[pos] == ids) & (ids >= 0)
    rows = delta.values[pos].to(torch.float32) * delta.scales[pos]
    return hit, rows


def delta_cached_rows(delta, cache, table, ids):
    """`hot_cache.cached_rows` resolved through the delta overlay first.

    Ids past the base table that miss the delta read zero rows.
    """
    rows, stats = cached_rows(cache, table, ids)
    if delta is None or delta.capacity == 0:
        return rows, stats
    in_range = (ids < table.values.shape[0])[..., None]
    hit, drows = delta_rows(delta, ids)
    return torch.where(hit[..., None], drows,
                       torch.where(in_range, rows, 0.0)), stats


def delta_cached_embedding_bag(delta, cache, table, ids, weights=None,
                               mode: str = "sum"):
    """`hot_cache.cached_embedding_bag` resolved through the delta."""
    rows, stats = delta_cached_rows(delta, cache, table, ids)  # (B, L, d)
    return pool_rows(rows, ids, weights, mode), stats
