"""Streaming fixed-radius NNS: key helpers and the CUDA kernel's wrapper.

The helpers mirror `repro/kernels/streaming_nns.py` and serve the plain
version (`kernels/ref.py`), which keeps the reference's int32 packed keys
``dist << shift | local_row`` and its superblock split: a packed key indexes
at most ``2**shift`` rows (4.19M at 256-bit signatures), so wider DBs scan
as superblocks whose sorted buffers merge with one stable sort on distance.

The CUDA kernel (`csrc/streaming_nns.cu`) keys candidates by the 64-bit
``dist << 32 | global_row`` instead, which orders exactly as (distance, row)
at any DB size; `superblock` only caps the rows of one first-pass split.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.utils import cdiv, round_up

# the invalid-slot distance sentinel of every NNS path (as in `repro`)
BIG_DIST = 2**30
# largest max_candidates of the CUDA kernel (its shared-memory buffer)
CUDA_MAX_CANDIDATES = 128
# split alignment of the CUDA kernel's first pass when nothing is pruned
CUDA_SPLIT_ALIGN = 1024
# queries per block of the first pass, and its largest split: its keys hold
# a split-local row in 23 bits
CUDA_QUERY_TILE = 128
CUDA_MAX_SPLIT_ROWS = 1 << 23
# per query of the kernel's histogram scratch: 257 distance bins, the
# length of its candidate list and its distance bound
_CUDA_HIST_COLS = 32 * 8 + 3


def key_shift(words: int) -> int:
    """Bits reserved for the db row index in the packed (dist, row) key."""
    return 31 - (32 * words + 1).bit_length()


def big_key(words: int) -> int:
    """Sentinel key strictly greater than every valid (dist, row) key."""
    return (32 * words + 1) << key_shift(words)


def max_streamable_items(words: int) -> int:
    """Rows one packed int32 key can index == the max superblock size."""
    return 1 << key_shift(words)


def pack_key(dist, row, words: int):
    """Pack (dist, superblock-local row) into one int32 sort key: key(a) <
    key(b) iff (dist_a, row_a) < (dist_b, row_b). Ints or tensors."""
    return dist * (1 << key_shift(words)) + row


def unpack_key(key, words: int):
    """Inverse of `pack_key`: key -> (dist, superblock-local row)."""
    shift = key_shift(words)
    return key >> shift, key & ((1 << shift) - 1)


def superblock_rows(words: int, block_n: int = 1,
                    superblock: int | None = None) -> int:
    """Rows per superblock: the packed-key capacity (or the `superblock`
    override, clamped to it) floored to a multiple of `block_n`."""
    cap = max_streamable_items(words)
    sb = cap if superblock is None else min(int(superblock), cap)
    sb = (sb // block_n) * block_n
    if sb <= 0:
        raise ValueError(
            f"superblock {superblock} smaller than one block ({block_n} "
            f"rows) at words={words}")
    return sb


def merge_candidate_buffers(indices: torch.Tensor, distances: torch.Tensor,
                            max_candidates: int):
    """Merge per-superblock sorted candidate buffers into the global top-K.

    `indices` / `distances` are (q, S*K), the S buffers concatenated in
    ascending-superblock order, each sorted by (distance, row) with
    (-1, BIG_DIST) at its tail; row ranges ascend across buffers, so one
    stable sort on distance gives the exact (distance, row) order.
    """
    order = torch.sort(distances, dim=-1, stable=True).indices
    order = order[:, :max_candidates]
    return (torch.gather(indices, 1, order), torch.gather(distances, 1, order))


def merge_chunk_buffers(chunks, max_candidates: int):
    """Merge the (indices, distances) buffers of ascending, disjoint row
    ranges (each (q, K), global row ids) — `merge_candidate_buffers`'s
    precondition — into the global top-K."""
    if not chunks:
        raise ValueError("merge_chunk_buffers: no chunks")
    if len(chunks) == 1:
        idx, dist = chunks[0]
        return idx[:, :max_candidates], dist[:, :max_candidates]
    idx = torch.cat([c[0] for c in chunks], dim=1)
    dist = torch.cat([c[1] for c in chunks], dim=1)
    return merge_candidate_buffers(idx, dist, max_candidates)


def split_layout(n: int, q: int, n_sms: int, *, prune_block_rows=None,
                 superblock=None) -> tuple[int, int]:
    """(split_rows, n_splits) of the kernel's first pass.

    Enough splits that (splits x query tiles of `CUDA_QUERY_TILE`) fills
    about two blocks per SM, the most that fit; splits are multiples of
    the summary block when pruning (a pruned block is skipped whole) and of
    `CUDA_SPLIT_ALIGN` rows otherwise, and at most `CUDA_MAX_SPLIT_ROWS`.
    """
    align = int(prune_block_rows) if prune_block_rows else CUDA_SPLIT_ALIGN
    want = max(1, cdiv(2 * n_sms, cdiv(max(q, 1), CUDA_QUERY_TILE)))
    split_rows = max(align, round_up(cdiv(max(n, 1), want), align))
    split_rows = min(split_rows, max(align, CUDA_MAX_SPLIT_ROWS // align
                                     * align))
    if superblock is not None:
        split_rows = min(split_rows, max(align, round_up(int(superblock),
                                                         align)))
    return split_rows, max(1, cdiv(n, split_rows))


def streaming_nns_cuda(queries: torch.Tensor, db: torch.Tensor, *,
                       radius: int, max_candidates: int, n_valid=None,
                       superblock: int | None = None, db_mask=None,
                       prune_blocks=None, prune_block_rows=None):
    """Launch `csrc/streaming_nns.cu` -> (indices, distances, counts).

    queries (q, words) / db (n, words) int32 packed signatures on one CUDA
    device; `db_mask` (n,) bool; `prune_blocks` (q, nb) bool, True = skip
    that summary block of `prune_block_rows` rows for that query.
    """
    dev = queries.device

    def check(t, name, dtype):
        build.check_tensor("streaming_nns", t, name, dtype, dev)

    check(queries, "queries", torch.int32)
    check(db, "db", torch.int32)
    q, words = queries.shape
    n, words2 = db.shape
    if words != words2 or not 1 <= words <= 8:
        raise ValueError(f"streaming_nns: words {words} vs {words2} (1..8)")
    if not 1 <= max_candidates <= CUDA_MAX_CANDIDATES:
        raise ValueError(f"streaming_nns: max_candidates {max_candidates} "
                         f"outside 1..{CUDA_MAX_CANDIDATES}")
    if q > CUDA_QUERY_TILE * 65535:
        raise ValueError(f"streaming_nns: {q} queries exceed the grid")
    limit = n if n_valid is None else max(0, min(int(n_valid), n))
    mask_ptr = prune_ptr = None
    nb = 0
    if db_mask is not None:
        check(db_mask, "db_mask", torch.bool)
        if db_mask.shape != (n,):
            raise ValueError(f"streaming_nns: db_mask {tuple(db_mask.shape)}")
        mask_ptr = db_mask.data_ptr()
    if prune_blocks is not None:
        check(prune_blocks, "prune_blocks", torch.bool)
        if prune_blocks.shape[0] != q or not prune_block_rows:
            raise ValueError("streaming_nns: prune_blocks must be (q, nb) "
                             "with prune_block_rows")
        nb = prune_blocks.shape[1]
        prune_ptr = prune_blocks.data_ptr()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split_rows, n_splits = split_layout(
        n, q, n_sms, prune_block_rows=prune_block_rows
        if prune_blocks is not None else None, superblock=superblock)
    if split_rows > CUDA_MAX_SPLIT_ROWS:
        raise ValueError(f"streaming_nns: prune_block_rows {prune_block_rows}"
                         f" above {CUDA_MAX_SPLIT_ROWS}")
    k = int(max_candidates)
    keys = torch.empty((q, n_splits, k), dtype=torch.int64, device=dev)
    split_counts = torch.empty((q, n_splits), dtype=torch.int32, device=dev)
    hist = torch.empty((q, _CUDA_HIST_COLS), dtype=torch.int32, device=dev)
    indices = torch.empty((q, k), dtype=torch.int32, device=dev)
    distances = torch.empty((q, k), dtype=torch.int32, device=dev)
    counts = torch.empty((q,), dtype=torch.int32, device=dev)
    build.STREAMING_NNS.launch(
        queries.data_ptr(), db.data_ptr(), mask_ptr, prune_ptr, q, n, words,
        limit, max(-1, min(int(radius), 32 * words)), k, split_rows, n_splits,
        int(prune_block_rows or 0), nb, keys.data_ptr(),
        split_counts.data_ptr(), hist.data_ptr(), indices.data_ptr(),
        distances.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    return indices, distances, counts
