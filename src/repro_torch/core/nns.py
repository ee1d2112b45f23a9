"""Fixed-radius Hamming NNS — the filtering-stage retrieval.

Mirrors `repro/core/nns.py`: `fixed_radius_nns` with its two plans behind
one `scan_block` knob (None routes by DB size at `STREAM_MIN_ITEMS`, 0
forces dense, > 0 forces streaming), and the block summaries that let the
streaming plan skip blocks whose sound Hamming lower bound exceeds the
radius. Both plans, pruned or not, return the same bits: candidates sorted
by (distance, row), padded (-1, BIG_DIST), and the count of all matches.
Each plan runs inside an `obs.span` (`nns.dense` > `nns.dense.select`,
`nns.stream` > `nns.stream.bounds`), so a profiler's trace says which plan
ran and what its selection and its prune bounds cost on the device.

The live catalog's scan (`delta_aware_nns`): the read-only base scans
through its plan with tombstoned rows masked (`db_mask`), the bounded
delta shard scans dense (`delta_scan`, global ids), and the two candidate
buffers merge into the exact (distance, id) order of a rebuilt table
(`merge_delta_candidates`). `out_of_core_nns` scans a host-resident
(memmapped) signature DB a chunk of admitted summary blocks at a time; a
memmap passed to `fixed_radius_nns` routes there.

The multi-device plans run SPMD on `torch.distributed`, a `DeviceMesh`
standing for the reference's `jax.sharding.Mesh`: every rank makes the
same call with the same (replicated) queries and gets the same result.
`sharded_fixed_radius_nns` takes the rank's bank of a row-sharded DB: each
bank scans its rows through its own plan (`bank_scan`, global ids, a
bounded buffer), the buffers are all-gathered over the bank axis and
re-selected (`merge_banks`): the paper's banks, priority encoder and RSC
bus. With a query axis too, each rank scans its block of the padded query
batch and the blocks are all-gathered along that axis.
`query_parallel_nns` and `query_parallel_delta_scan` block the queries
over a replicated DB. Candidate buffers travel as one packed int32 tensor
a gather; counts add exactly in any order.

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
from repro_torch.kernels.streaming_nns import (
    BIG_DIST,
    merge_candidate_buffers,
)
from repro_torch.obs import span
from repro_torch.utils import (
    all_gather_axis,
    cdiv,
    mesh_axis_size,
    to_device,
)

# dense materializes q*n int32 — at and above this DB size the O(q*K)
# streaming scan is the default plan
STREAM_MIN_ITEMS = 1 << 18
DEFAULT_SCAN_BLOCK = 4096
# default BlockSummary granularity (rows per summary block), a multiple
# of 128
SUMMARY_BLOCK_ROWS = 4096
# summary blocks per vectorized host sweep (bounds temporary memory)
_BUILD_CHUNK_BLOCKS = 64
# rows a chunk of the out-of-core scan: 8 MB of 256-bit signatures
OUTOFCORE_CHUNK_ROWS = 1 << 18
# the empty delta slot's id: sorts after every real item id, so a delta
# shard kept sorted by id has its live slots in an ascending prefix
EMPTY_ID = 2**31 - 1


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


def update_block_summary(summary: BlockSummary, db_sigs, db_mask,
                         touched_rows) -> BlockSummary:
    """Recompute, exactly, every block of `summary` holding a row of
    `touched_rows` against `db_sigs` / `db_mask` (host-side, O(touched
    blocks)). Tombstoning must tighten a block's bound, and an incremental
    OR / AND cannot unset bits, so touched blocks are rebuilt; the result
    equals `build_block_summary` over the same (db_sigs, db_mask). New
    tensors on the summary's device."""
    rows = np.unique(np.asarray(touched_rows, np.int64).reshape(-1))
    sigs = _host_u32(db_sigs)
    n, words = sigs.shape
    br = summary.block_rows
    rows = rows[(rows >= 0) & (rows < n)]
    if rows.size == 0:
        return summary
    if db_mask is None:
        elig = np.ones(n, bool)
    else:
        elig = (db_mask.cpu().numpy() if isinstance(db_mask, torch.Tensor)
                else np.asarray(db_mask)).astype(bool)[:n]
    blocks = np.unique(rows // br)
    blocks = blocks[blocks < summary.n_blocks]
    arrays = [_host_u32(summary.or_sigs).copy(),
              _host_u32(summary.and_sigs).copy(),
              summary.min_pc.cpu().numpy().copy(),
              summary.max_pc.cpu().numpy().copy(),
              summary.n_alive.cpu().numpy().copy()]
    for b in blocks:
        lo, hi = int(b) * br, min(int(b) * br + br, n)
        s = np.zeros((br, words), np.uint32)
        e = np.zeros((br,), bool)
        s[: hi - lo] = sigs[lo:hi]
        e[: hi - lo] = elig[lo:hi]
        for a, v in zip(arrays, _summarize_blocks(s[None], e[None])):
            a[b] = v[0]
    return BlockSummary(*to_device(arrays, summary.or_sigs.device),
                        block_rows=br)


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
    also report the per-query `blocks_touched`. An `np.memmap` `db_sigs`
    (with a host `db_mask`) scans out of core (`out_of_core_nns`).
    """
    if isinstance(db_sigs, np.memmap):
        return out_of_core_nns(
            query_sigs, db_sigs, radius, max_candidates, db_mask=db_mask,
            scan_block=scan_block, n_valid=n_valid, summary=summary,
            prune=prune)
    n, _ = db_sigs.shape
    use_stream = _plan_streams(n, scan_block)
    block = DEFAULT_SCAN_BLOCK if not scan_block else scan_block

    if use_stream:
        with span("nns.stream"):
            prune_blocks = blocks_touched = block_rows = None
            if summary is not None and prune is not False:
                with span("nns.stream.bounds"):
                    prune_blocks, blocks_touched = _prune_mask(
                        query_sigs, summary, radius)
                block_rows = summary.block_rows
            indices, distances, counts = ops.streaming_nns(
                query_sigs, db_sigs, radius=radius,
                max_candidates=max_candidates, scan_block=block,
                n_valid=n_valid, superblock=superblock, db_mask=db_mask,
                prune_blocks=prune_blocks, prune_block_rows=block_rows)
        return NNSResult(indices=indices, distances=distances, counts=counts,
                         blocks_touched=blocks_touched)

    with span("nns.dense"):
        d = ops.hamming_distances(query_sigs, db_sigs)  # (q, n)
        with span("nns.dense.select"):
            return _dense_select(d, radius, max_candidates, db_mask,
                                 n_valid)


def _dense_select(d, radius, max_candidates, db_mask, n_valid) -> NNSResult:
    """`fixed_radius_nns`' dense plan after the (q, n) distances `d`: the
    rows within `radius`, their count, and the first `max_candidates` by
    (distance, row)."""
    n = d.shape[1]
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


def out_of_core_nns(
    query_sigs: torch.Tensor,  # (q, words) int32
    db_sigs: np.ndarray,  # (n, words) uint32 / int32 host array or memmap
    radius: int,
    max_candidates: int = 128,
    db_mask=None,  # (n,) bool host array — tombstones
    *,
    scan_block: int | None = None,
    n_valid: int | None = None,
    summary: BlockSummary | None = None,
    prune: bool | None = None,
    chunk_rows: int = OUTOFCORE_CHUNK_ROWS,
) -> NNSResult:
    """Fixed-radius NNS over a host-resident (memmapped) signature DB.

    Only summary blocks that some query admits are gathered, a chunk of
    `chunk_rows` rows at a time (`ops.streaming_nns_outofcore`), so the
    pages of blocks every query prunes are never read. The prune mask is
    computed on the queries' device and read back once. Results, and
    `blocks_touched`, equal the resident streaming scan's with the same
    mask and summary.
    """
    block = DEFAULT_SCAN_BLOCK if not scan_block else scan_block
    prune_np = blocks_touched = block_rows = None
    if summary is not None and prune is not False:
        pm, blocks_touched = _prune_mask(query_sigs, summary, radius)
        prune_np = pm.cpu().numpy()
        block_rows = summary.block_rows
    indices, distances, counts = ops.streaming_nns_outofcore(
        query_sigs, db_sigs, radius=radius, max_candidates=max_candidates,
        scan_block=block, n_valid=n_valid, db_mask=db_mask,
        prune_blocks=prune_np, prune_block_rows=block_rows,
        chunk_rows=chunk_rows)
    return NNSResult(indices=indices, distances=distances, counts=counts,
                     blocks_touched=blocks_touched)


def fixed_radius_nns_async(
    query_sigs: torch.Tensor,  # (q, words) int32
    db_sigs: torch.Tensor,  # (n, words) int32, on the queries' device
    radius: int,
    max_candidates: int = 128,
    db_mask: torch.Tensor | None = None,
    *,
    scan_block: int | None = None,
    n_valid: int | None = None,
    superblock: int | None = None,
    summary: BlockSummary | None = None,
    prune: bool | None = None,
) -> NNSResult:
    """Non-blocking filtering scan: the same arguments and bits as
    `fixed_radius_nns`, queued on the current stream, returning tensors
    still being computed. Nothing waits for the device until the caller
    reads a result (`.cpu()`, an event, `torch.cuda.synchronize`). A
    host-resident (memmapped) DB is refused: its out-of-core scan reads
    the prune mask back to the host."""
    if not isinstance(db_sigs, torch.Tensor):
        raise TypeError("fixed_radius_nns_async: db_sigs must be a tensor "
                        "(out-of-core scans synchronize)")
    return fixed_radius_nns(query_sigs, db_sigs, radius, max_candidates,
                            db_mask, scan_block=scan_block, n_valid=n_valid,
                            superblock=superblock, summary=summary,
                            prune=prune)


# ---------------------------------------------------------------------------
# multi-device plans (SPMD over a DeviceMesh)
# ---------------------------------------------------------------------------
def _pad_queries_to_axis(mesh, query_axis, query_sigs):
    """Pad the query batch with zero rows to a multiple of the query-axis
    size -> (padded queries, pad count); `_slice_query_pad` drops the pad
    rows from the result."""
    pad = (-query_sigs.shape[0]) % mesh_axis_size(mesh, query_axis)
    if pad:
        query_sigs = torch.nn.functional.pad(query_sigs, (0, 0, 0, pad))
    return query_sigs, pad


def _slice_query_pad(res: NNSResult, pad: int) -> NNSResult:
    if not pad:
        return res
    q = res.counts.shape[0] - pad
    bt = None if res.blocks_touched is None else res.blocks_touched[:q]
    return NNSResult(indices=res.indices[:q], distances=res.distances[:q],
                     counts=res.counts[:q], blocks_touched=bt)


def _gather_packed(res: NNSResult, mesh, axis: str) -> list:
    """`res` of every rank along `axis`, in rank order, each packed as one
    int32 tensor (candidates, distances, counts and blocks touched side by
    side): one all-gather a call. `_unpack` undoes the packing."""
    cols = [res.indices, res.distances, res.counts[:, None]]
    if res.blocks_touched is not None:
        cols.append(res.blocks_touched[:, None])
    return all_gather_axis(torch.cat(cols, dim=1), mesh, axis)


def _unpack(packed: torch.Tensor, k: int, blocks: bool) -> NNSResult:
    return NNSResult(indices=packed[:, :k], distances=packed[:, k:2 * k],
                     counts=packed[:, 2 * k],
                     blocks_touched=packed[:, 2 * k + 1] if blocks else None)


def _over_query_blocks(mesh, query_axis: str, query_sigs, scan):
    """`scan` of this rank's block of the query batch (padded to a
    multiple of the axis size), the blocks all-gathered along `query_axis`
    in rank order and the pad rows dropped: every rank returns the whole
    batch's result."""
    padded, pad = _pad_queries_to_axis(mesh, query_axis, query_sigs)
    rows = padded.shape[0] // mesh_axis_size(mesh, query_axis)
    lo = mesh.get_local_rank(query_axis) * rows
    res = scan(padded[lo:lo + rows])
    whole = torch.cat(_gather_packed(res, mesh, query_axis))
    return _slice_query_pad(
        _unpack(whole, res.indices.shape[1], res.blocks_touched is not None),
        pad)


def bank_scan(
    query_sigs: torch.Tensor,  # (q, words) int32
    bank_sigs: torch.Tensor,  # (per_bank, words) int32 — one bank's rows
    radius: int,
    max_candidates: int,
    *,
    bank: int,
    n_valid: int,  # global: rows >= n_valid never match
    scan_block: int | None = None,
    superblock: int | None = None,
    db_mask: torch.Tensor | None = None,  # (per_bank,) bool, the bank's
    summary: BlockSummary | None = None,  # the bank's blocks; prunes
) -> NNSResult:
    """One bank's part of `sharded_fixed_radius_nns`: bank `bank` of
    equal `per_bank`-row banks scans its rows through its own plan (dense
    or streaming by `per_bank` and `scan_block`, pruned when `summary` is
    given) -> its best ``min(max_candidates, per_bank)`` candidates by
    (distance, row) with GLOBAL ids, and the bank's own counts and blocks
    touched. A pure function of the bank: `merge_banks` over every bank's
    result is the sharded plan without a collective."""
    per_bank = bank_sigs.shape[0]
    lo = bank * per_bank
    res = fixed_radius_nns(
        query_sigs, bank_sigs, radius, min(max_candidates, per_bank),
        db_mask=db_mask, scan_block=scan_block,
        n_valid=min(max(n_valid - lo, 0), per_bank), superblock=superblock,
        summary=summary, prune=summary is not None)
    return res._replace(
        indices=torch.where(res.indices >= 0, res.indices + lo, -1))


def merge_banks(banks: list, max_candidates: int) -> NNSResult:
    """Merge the `bank_scan` results of every bank, in bank order, into
    the exact (distance, global id) order of one scan over all rows.

    The buffers concatenate bank by bank; one stable sort on distance
    breaks ties by bank and then by the bank's own (distance, row) order,
    that is by global id (the reference's `lax.top_k` over the bank-major
    concatenation). ``min(max_candidates, total slots)`` survive, padded
    with (-1, BIG_DIST). Counts and blocks touched add (integers: exact in
    any order).
    """
    idx = torch.cat([b.indices for b in banks], dim=1)
    dist = torch.cat([b.distances for b in banks], dim=1)
    k = min(max_candidates, dist.shape[1])
    idx, dist = merge_candidate_buffers(idx, dist, k)
    if k < max_candidates:
        pad = max_candidates - k
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        dist = torch.nn.functional.pad(dist, (0, pad), value=BIG_DIST)
    counts = banks[0].counts
    for b in banks[1:]:
        counts = counts + b.counts
    bt = banks[0].blocks_touched
    if bt is not None:
        for b in banks[1:]:
            bt = bt + b.blocks_touched
    return NNSResult(indices=idx, distances=dist, counts=counts,
                     blocks_touched=bt)


def sharded_fixed_radius_nns(
    mesh,  # torch.distributed DeviceMesh
    axis: str,
    query_sigs: torch.Tensor,  # (q, words) int32, the same on every rank
    db_sigs: torch.Tensor,  # (per_bank, words) int32 — this rank's bank
    radius: int,
    max_candidates: int = 128,
    n_valid: int | None = None,  # global: rows >= n_valid are padding
    *,
    scan_block: int | None = None,  # forwarded to the bank's scan
    query_axis: str | None = None,  # also block the queries over this axis
    superblock: int | None = None,
    db_mask: torch.Tensor | None = None,  # (per_bank,) bool, the bank's
    summary: BlockSummary | None = None,  # the bank's summary blocks
    prune: bool | None = None,  # None=auto, False=off
) -> NNSResult:
    """Fixed-radius NNS with the item DB row-sharded over `mesh[axis]`.

    Every rank holds one bank: `db_sigs`, `db_mask` and `summary` are its
    slices of the DB padded to ``per_bank * n_banks`` rows (bank b holds
    global rows ``[b * per_bank, (b + 1) * per_bank)``; `utils.bank_slice`
    cuts them), and `n_valid` (default: every row) keeps the pad rows from
    matching. The bank scans (`bank_scan`), the bounded buffers are
    all-gathered over `axis` and re-selected (`merge_banks`), and counts
    and blocks touched add over the banks. Returned ids are global.

    `query_axis` also blocks the query batch over a second axis: each rank
    scans its block of the batch, padded to a multiple of that axis' size,
    against its bank, and the merged blocks are all-gathered along
    `query_axis` (pad rows dropped), so every rank returns the whole
    batch's result.

    The bank prunes with `summary` when the scan streams, ``per_bank`` is a
    multiple of `summary.block_rows` and the summary covers exactly the
    bank; otherwise it scans unpruned (same bits, no `blocks_touched`).
    """
    per_bank = db_sigs.shape[0]
    n_valid = per_bank * mesh_axis_size(mesh, axis) if n_valid is None \
        else n_valid
    use_prune = (
        summary is not None and prune is not False
        and _plan_streams(per_bank, scan_block)
        and per_bank % summary.block_rows == 0
        and summary.n_blocks * summary.block_rows == per_bank)

    def scan(queries):
        local = bank_scan(queries, db_sigs, radius, max_candidates,
                          bank=mesh.get_local_rank(axis), n_valid=n_valid,
                          scan_block=scan_block, superblock=superblock,
                          db_mask=db_mask,
                          summary=summary if use_prune else None)
        k = local.indices.shape[1]
        return merge_banks([_unpack(p, k, use_prune) for p in
                            _gather_packed(local, mesh, axis)],
                           max_candidates)

    if query_axis is None:
        return scan(query_sigs)
    return _over_query_blocks(mesh, query_axis, query_sigs, scan)


def query_parallel_nns(
    mesh,  # torch.distributed DeviceMesh
    query_axis: str,
    query_sigs: torch.Tensor,  # (q, words) int32, the same on every rank
    db_sigs: torch.Tensor,  # (n, words) int32, replicated
    radius: int,
    max_candidates: int = 128,
    *,
    scan_block: int | None = None,
    n_valid: int | None = None,
    superblock: int | None = None,
    db_mask: torch.Tensor | None = None,  # (n,) bool, replicated
    summary: BlockSummary | None = None,  # replicated with the DB
    prune: bool | None = None,  # None=auto, False=off
) -> NNSResult:
    """Fixed-radius NNS with the query batch blocked over
    `mesh[query_axis]` and the DB replicated: each rank scans the whole
    DB for its block of the batch (padded to a multiple of the axis size),
    and the blocks are all-gathered along the axis (pad rows dropped). No
    candidate gather across banks: the dual of the sharded plan."""
    return _over_query_blocks(
        mesh, query_axis, query_sigs, lambda queries: fixed_radius_nns(
            queries, db_sigs, radius, max_candidates, db_mask=db_mask,
            scan_block=scan_block, n_valid=n_valid, superblock=superblock,
            summary=summary, prune=prune))


def delta_scan(
    query_sigs: torch.Tensor,  # (q, words) int32
    delta_sigs: torch.Tensor,  # (D, words) int32 — delta shard signatures
    delta_ids: torch.Tensor,  # (D,) int32 — global id a slot, EMPTY_ID free
    radius: int,
    max_candidates: int = 128,
) -> NNSResult:
    """Scan the delta shard densely; the indices are GLOBAL item ids.

    Live slots are sorted by id (`serving/catalog.py` keeps them so), so
    the (distance, slot) truncation keeps exactly what a (distance, id)
    truncation would. Free slots (`EMPTY_ID`) never match or count.
    """
    k = min(max_candidates, delta_sigs.shape[0])
    res = fixed_radius_nns(query_sigs, delta_sigs, radius, k,
                           db_mask=delta_ids != EMPTY_ID, scan_block=0)
    gids = torch.where(res.indices >= 0,
                       delta_ids[res.indices.clamp(min=0).long()], -1)
    dist = res.distances
    if k < max_candidates:
        pad = max_candidates - k
        gids = torch.nn.functional.pad(gids, (0, pad), value=-1)
        dist = torch.nn.functional.pad(dist, (0, pad), value=BIG_DIST)
    return NNSResult(indices=gids, distances=dist, counts=res.counts)


def merge_delta_candidates(base: NNSResult, delta: NNSResult,
                           max_candidates: int) -> NNSResult:
    """Merge the base and delta candidate buffers into the exact (distance,
    id) order of a rebuilt table.

    An id is in at most one buffer (an overwritten base row is tombstoned
    out of the base scan). One stable sort on id (invalid slots last) puts
    the concatenation in ascending-id order; `merge_candidate_buffers`'
    stable sort on distance then breaks ties by id. Counts add; the base
    scan's `blocks_touched` passes through (the delta scan is dense).
    """
    ids = torch.cat([base.indices, delta.indices], dim=1)
    dist = torch.cat([base.distances, delta.distances], dim=1)
    order = torch.sort(torch.where(ids < 0, EMPTY_ID, ids), dim=-1,
                       stable=True).indices
    ids = torch.gather(ids, 1, order)
    dist = torch.gather(dist, 1, order)
    idx, d = merge_candidate_buffers(ids, dist, max_candidates)
    return NNSResult(indices=idx, distances=d,
                     counts=base.counts + delta.counts,
                     blocks_touched=base.blocks_touched)


def query_parallel_delta_scan(
    mesh,  # torch.distributed DeviceMesh
    query_axis: str,
    query_sigs: torch.Tensor,  # (q, words) int32, the same on every rank
    delta_sigs: torch.Tensor,  # (D, words) int32, replicated
    delta_ids: torch.Tensor,  # (D,) int32, replicated; EMPTY_ID free
    radius: int,
    max_candidates: int = 128,
) -> NNSResult:
    """`delta_scan` with the query batch blocked over `mesh[query_axis]`:
    each rank scans the whole (bounded, replicated) delta shard for its
    block of the padded batch, and the blocks are all-gathered along the
    axis (pad rows dropped). Per query independent, so the bits equal the
    replicated scan's."""
    return _over_query_blocks(
        mesh, query_axis, query_sigs, lambda queries: delta_scan(
            queries, delta_sigs, delta_ids, radius, max_candidates))


def delta_aware_nns(
    query_sigs: torch.Tensor,  # (q, words) int32
    db_sigs: torch.Tensor,  # (n, words) int32 — read-only base epoch
    delta_sigs: torch.Tensor,  # (D, words) int32 — bounded delta shard
    delta_ids: torch.Tensor,  # (D,) int32 — global ids, EMPTY_ID = free
    radius: int,
    max_candidates: int = 128,
    *,
    db_mask: torch.Tensor | None = None,  # (n,) bool — base tombstones
    scan_block: int | None = None,
    n_valid: int | None = None,
    superblock: int | None = None,
    summary: BlockSummary | None = None,
    prune: bool | None = None,
) -> NNSResult:
    """Fixed-radius NNS over a read-only base plus the delta shard: the
    base through its plan (tombstones masked, optionally pruned), the
    delta dense, merged — equal to `fixed_radius_nns` over the rebuilt
    table."""
    base = fixed_radius_nns(query_sigs, db_sigs, radius, max_candidates,
                            db_mask=db_mask, scan_block=scan_block,
                            n_valid=n_valid, superblock=superblock,
                            summary=summary, prune=prune)
    delta = delta_scan(query_sigs, delta_sigs, delta_ids, radius,
                       max_candidates)
    return merge_delta_candidates(base, delta, max_candidates)


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
