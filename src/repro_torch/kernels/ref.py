"""Plain PyTorch versions of the three kernels of the serve path.

They mirror `repro/kernels/ref.py` op for op: the CPU tests run them
against the JAX reference, a CPU tensor takes them in `kernels/ops.py`, and
on the card they are what each CUDA kernel is held against. Signatures are
int32 tensors holding the uint32 bits; PyTorch has no popcount and no
uint32 shift on the CPU, so the popcount is a bit trick on int64.
"""
from __future__ import annotations

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


def embedding_pool_ref(
    table_values: torch.Tensor,  # (n, d) int8
    table_scales: torch.Tensor,  # (n, 1) f32
    ids: torch.Tensor,  # (B, L) int32, -1 = padding
    weights: torch.Tensor | None = None,  # (B, L) f32
) -> torch.Tensor:
    """Fused int8 dequant-gather-pool -> (B, d) f32."""
    valid = (ids >= 0).to(torch.float32)
    safe = ids.clamp(0, table_values.shape[0] - 1).long()  # as jnp clamps
    rows = table_values[safe].to(torch.float32)  # (B, L, d)
    scales = table_scales[safe]  # (B, L, 1)
    w = valid if weights is None else weights.to(torch.float32) * valid
    return torch.einsum("bld,bl->bd", rows * scales, w)


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
