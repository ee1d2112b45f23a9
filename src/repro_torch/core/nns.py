"""Fixed-radius Hamming NNS — the filtering-stage retrieval (frozen part).

Mirrors `repro/core/nns.py`: `fixed_radius_nns` with its two plans behind
one `scan_block` knob (None routes by DB size at `STREAM_MIN_ITEMS`, 0
forces dense, > 0 forces streaming), and the block summaries that let the
streaming plan skip blocks whose sound Hamming lower bound exceeds the
radius. Both plans, pruned or not, return the same bits: candidates sorted
by (distance, row), padded (-1, BIG_DIST), and the count of all matches.

Signatures are int32 tensors holding the uint32 bits. The summary is built
on the host with numpy (uint32 views), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import popcount32
from repro_torch.kernels.streaming_nns import BIG_DIST
from repro_torch.utils import cdiv, to_device

# dense materializes q*n int32 — at and above this DB size the O(q*K)
# streaming scan is the default plan
STREAM_MIN_ITEMS = 1 << 18
DEFAULT_SCAN_BLOCK = 4096
# default BlockSummary granularity (rows per summary block), a multiple
# of 128
SUMMARY_BLOCK_ROWS = 4096
# summary blocks per vectorized host sweep (bounds temporary memory)
_BUILD_CHUNK_BLOCKS = 64


class NNSResult(NamedTuple):
    indices: torch.Tensor  # (q, max_candidates) int32, -1 padded
    distances: torch.Tensor  # (q, max_candidates) int32, BIG_DIST invalid
    counts: torch.Tensor  # (q,) int32 — total matches within radius
    # (q,) int32 — summary blocks admitted per query; None when unpruned
    blocks_touched: torch.Tensor | None = None


@dataclass(frozen=True)
class BlockSummary:
    """Per-block occupancy summary of a packed-signature DB, for pruning.

    Over each block's eligible rows: the OR / AND of the signatures, the
    per-word popcount range, and the eligible-row count. See
    `summary_block_bounds` for the bound they give.
    """

    or_sigs: torch.Tensor  # (n_blocks, words) int32 — OR of eligible rows
    and_sigs: torch.Tensor  # (n_blocks, words) int32 — AND of eligible rows
    min_pc: torch.Tensor  # (n_blocks, words) int32
    max_pc: torch.Tensor  # (n_blocks, words) int32
    n_alive: torch.Tensor  # (n_blocks,) int32
    block_rows: int = SUMMARY_BLOCK_ROWS

    @property
    def n_blocks(self) -> int:
        return self.or_sigs.shape[0]


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    """Vectorized host-side popcount over uint32 arrays -> int32 counts."""
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2))
                                       & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


def _summarize_blocks(sigs3: np.ndarray, elig3: np.ndarray):
    """(nb, block_rows, words) uint32 sigs + (nb, block_rows) eligibility ->
    the five per-block summary arrays (numpy)."""
    e = elig3[..., None]
    or_sigs = np.bitwise_or.reduce(
        np.where(e, sigs3, np.uint32(0)), axis=1).astype(np.uint32)
    and_sigs = np.bitwise_and.reduce(
        np.where(e, sigs3, np.uint32(0xFFFFFFFF)), axis=1).astype(np.uint32)
    pc = _popcount_u32(sigs3)
    min_pc = np.min(np.where(e, pc, np.int32(33)), axis=1).astype(np.int32)
    max_pc = np.max(np.where(e, pc, np.int32(-1)), axis=1).astype(np.int32)
    n_alive = elig3.sum(axis=1).astype(np.int32)
    return or_sigs, and_sigs, min_pc, max_pc, n_alive


def _host_u32(sigs) -> np.ndarray:
    if isinstance(sigs, torch.Tensor):
        sigs = sigs.cpu().numpy()
    return np.ascontiguousarray(sigs).view(np.uint32)


def build_block_summary(db_sigs, block_rows: int = SUMMARY_BLOCK_ROWS, *,
                        db_mask=None, n_valid: int | None = None
                        ) -> BlockSummary:
    """Build a `BlockSummary` over `db_sigs` (host-side, numpy).

    `db_sigs` is a (n, words) int32 tensor or a uint32/int32 array; the
    eligible rows are ``db_mask AND row < n_valid``. `block_rows` must be
    a positive multiple of 128. The summary lands on the tensor's device
    (the CPU for an array).
    """
    block_rows = int(block_rows)
    if block_rows <= 0 or block_rows % 128:
        raise ValueError(f"block_rows must be a positive multiple of 128, "
                         f"got {block_rows}")
    device = (db_sigs.device if isinstance(db_sigs, torch.Tensor)
              else torch.device("cpu"))
    sigs = _host_u32(db_sigs)
    n, words = sigs.shape
    nb = max(1, cdiv(n, block_rows))
    if db_mask is None:
        elig = np.ones(n, bool)
    else:
        mask = (db_mask.cpu().numpy() if isinstance(db_mask, torch.Tensor)
                else np.asarray(db_mask))
        elig = mask.astype(bool)[:n].copy()
    if n_valid is not None:
        elig &= np.arange(n) < int(n_valid)

    or_sigs = np.zeros((nb, words), np.uint32)
    and_sigs = np.full((nb, words), np.uint32(0xFFFFFFFF), np.uint32)
    min_pc = np.full((nb, words), 33, np.int32)
    max_pc = np.full((nb, words), -1, np.int32)
    n_alive = np.zeros((nb,), np.int32)
    for b0 in range(0, nb, _BUILD_CHUNK_BLOCKS):
        b1 = min(b0 + _BUILD_CHUNK_BLOCKS, nb)
        lo, hi = b0 * block_rows, min(b1 * block_rows, n)
        rows = (b1 - b0) * block_rows
        s = np.zeros((rows, words), np.uint32)
        e = np.zeros((rows,), bool)
        s[: hi - lo] = sigs[lo:hi]
        e[: hi - lo] = elig[lo:hi]
        (or_sigs[b0:b1], and_sigs[b0:b1], min_pc[b0:b1], max_pc[b0:b1],
         n_alive[b0:b1]) = _summarize_blocks(
            s.reshape(b1 - b0, block_rows, words),
            e.reshape(b1 - b0, block_rows))
    return BlockSummary(
        *to_device([or_sigs, and_sigs, min_pc, max_pc, n_alive], device),
        block_rows=block_rows)


def summary_block_bounds(query_sigs: torch.Tensor,
                         summary: BlockSummary) -> torch.Tensor:
    """(q, words) queries x summary -> (q, n_blocks) int32 lower bounds.

    Per word, the larger of the occupancy bound popcount(q & ~or) +
    popcount(~q & and) and the popcount-range bound, summed over words;
    blocks with no eligible row bound to BIG_DIST (always pruned).
    """
    q = query_sigs[:, None, :]
    occ = (popcount32(q & ~summary.or_sigs[None])
           + popcount32(~q & summary.and_sigs[None]))
    pcq = popcount32(q)
    rng = torch.maximum(pcq - summary.max_pc[None],
                        summary.min_pc[None] - pcq)
    per_word = torch.maximum(occ, rng.clamp(min=0))
    total = per_word.sum(-1, dtype=torch.int32)
    return torch.where(summary.n_alive[None] > 0, total, BIG_DIST)


def _prune_mask(query_sigs, summary, radius):
    """-> (prune (q, n_blocks) bool, blocks_touched (q,) int32)."""
    prune = summary_block_bounds(query_sigs, summary) > radius
    touched = (~prune).sum(-1, dtype=torch.int32)
    return prune, touched


def _plan_streams(n_rows: int, scan_block: int | None) -> bool:
    """Dense-vs-streaming routing of `fixed_radius_nns`."""
    if scan_block is None:
        return n_rows >= STREAM_MIN_ITEMS
    return scan_block != 0


def fixed_radius_nns(
    query_sigs: torch.Tensor,  # (q, words) int32
    db_sigs: torch.Tensor,  # (n, words) int32
    radius: int,
    max_candidates: int = 128,
    db_mask: torch.Tensor | None = None,  # (n,) bool — rows eligible
    *,
    scan_block: int | None = None,  # None=auto, 0=dense, >0=streaming chunk
    n_valid: int | None = None,  # rows >= n_valid never match
    superblock: int | None = None,  # streaming superblock rows (testing)
    summary: BlockSummary | None = None,  # enables pruning when streaming
    prune: bool | None = None,  # None=auto (prune when summary), False=off
) -> NNSResult:
    """All db items within Hamming `radius` of each query (bounded, sorted).

    Candidates are sorted by (distance, index) ascending — the exact dense
    threshold + top-k order, whatever the plan. Pruned streaming scans
    also report the per-query `blocks_touched`.
    """
    n, _ = db_sigs.shape
    use_stream = _plan_streams(n, scan_block)
    block = DEFAULT_SCAN_BLOCK if not scan_block else scan_block

    if use_stream:
        prune_blocks = blocks_touched = block_rows = None
        if summary is not None and prune is not False:
            prune_blocks, blocks_touched = _prune_mask(
                query_sigs, summary, radius)
            block_rows = summary.block_rows
        indices, distances, counts = ops.streaming_nns(
            query_sigs, db_sigs, radius=radius,
            max_candidates=max_candidates, scan_block=block, n_valid=n_valid,
            superblock=superblock, db_mask=db_mask,
            prune_blocks=prune_blocks, prune_block_rows=block_rows)
        return NNSResult(indices=indices, distances=distances, counts=counts,
                         blocks_touched=blocks_touched)

    d = ops.hamming_distances(query_sigs, db_sigs)  # (q, n)
    within = d <= radius
    if n_valid is not None:
        rows = torch.arange(n, device=d.device)
        within &= (rows < n_valid)[None, :]
    if db_mask is not None:
        within &= db_mask[None, :]
    counts = within.sum(-1, dtype=torch.int32)
    masked = torch.where(within, d, BIG_DIST)
    # smallest distances first, ties to the lower row (lax.top_k's order)
    k = min(max_candidates, n)
    dist, idx = torch.sort(masked, dim=-1, stable=True)
    dist, idx = dist[:, :k], idx[:, :k].to(torch.int32)
    valid = dist < BIG_DIST
    idx = torch.where(valid, idx, -1)
    dist = torch.where(valid, dist, BIG_DIST)
    if k < max_candidates:  # tiny db: pad out
        pad = max_candidates - k
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        dist = torch.nn.functional.pad(dist, (0, pad), value=BIG_DIST)
    return NNSResult(indices=idx, distances=dist, counts=counts)


def cosine_topk(query_vecs: torch.Tensor, db_vecs: torch.Tensor, k: int):
    """Exact cosine top-k (flat search) -> (scores (q, k) f32, ids (q, k)
    int32). A stable descending sort, so ties go to the lower id as
    `jax.lax.top_k` gives them."""
    qn = query_vecs / torch.linalg.norm(
        query_vecs, dim=-1, keepdim=True).clamp(min=1e-12)
    dn = db_vecs / torch.linalg.norm(
        db_vecs, dim=-1, keepdim=True).clamp(min=1e-12)
    sims = qn @ dn.T
    vals, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)
