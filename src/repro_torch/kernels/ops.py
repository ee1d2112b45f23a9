"""Public kernel ops: the CUDA kernel for a CUDA tensor, else the plain one.

Routing follows the tensors, never an error: a CPU tensor takes the plain
PyTorch version (`kernels/ref.py`); a CUDA tensor launches the kernel
(`kernels/csrc`) and any failure raises. For comparisons on the card,
``REPRO_TORCH_<OP>=torch`` (e.g. ``REPRO_TORCH_STREAMING_NNS=torch``)
sends that op's CUDA tensors to the plain version too; ``cuda`` (or unset)
is the default. Each kernel counts its launches (`launch_counts`), which
is how a run shows that the serve path went through the kernels.

Signatures mirror `repro/kernels/ops.py`.
"""
from __future__ import annotations

import ctypes
import mmap
import os

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.build import launch_counts, reset_launches
from repro_torch.kernels.ref import PoolSegment, SideTable
from repro_torch.kernels.streaming_nns import (
    BIG_DIST,
    merge_chunk_buffers,
    streaming_nns_cuda,
)

__all__ = ["PoolPlan", "PoolSegment", "SideTable", "embedding_pool",
           "flash_attention", "flash_attention_bhsd", "grouped_pool",
           "hamming_distances", "int8_matmul", "madvise_dontneed",
           "madvise_random", "streaming_nns", "streaming_nns_outofcore",
           "launch_counts", "reset_launches", "use_kernel"]

_MODES = ("cuda", "torch")
_FLASH_HEAD_DIMS = (16, 32, 64, 128)  # instantiated in flash_attention.cu
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# int8_matmul.cu sums in int32: |x w| <= 128 * 128 a term, so k * 2**14
# stays below 2**31 for k up to this
_INT8_MAX_K = 2**31 // 2**14 - 1
# hamming.cu: 64-query tiles on the grid's y extent, 64-row tiles indexed
# in int32
_HAMMING_MAX_Q = 65535 * 64
_HAMMING_MAX_N = 2**31 - 1 - 64
# embedding_pool.cu: segments a launch, and int64 fields a segment per call
_POOL_MAX_SEGMENTS = 8
_POOL_CALL_FIELDS = 11
# chunks of the out-of-core scan in flight at once: each holds a pinned
# staging buffer until its copy's event
_OUTOFCORE_INFLIGHT = 2


def use_kernel(name: str, t: torch.Tensor) -> bool:
    """True when op `name` on tensor `t` launches its CUDA kernel."""
    mode = os.environ.get(f"REPRO_TORCH_{name.upper()}", "cuda")
    if mode not in _MODES:
        raise ValueError(f"REPRO_TORCH_{name.upper()}={mode!r}: "
                         f"expected one of {_MODES}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return mode == "cuda"


def _hamming_cuda(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    dev = queries.device
    _check("hamming_distances", queries, "queries", torch.int32, dev)
    _check("hamming_distances", db, "db", torch.int32, dev)
    q, words = queries.shape
    n, words2 = db.shape
    if words != words2 or not 1 <= words <= 8:
        raise ValueError(f"hamming_distances: words {words} vs {words2}")
    if q > _HAMMING_MAX_Q or n > _HAMMING_MAX_N:
        raise ValueError(f"hamming_distances: {q} queries x {n} rows exceed "
                         f"the grid ({_HAMMING_MAX_Q} x {_HAMMING_MAX_N})")
    # rows padded to 16 bytes, so that the kernel's row stores all align;
    # the result is the (q, n) view
    ld = -(-n // 4) * 4
    out = torch.empty((q, ld), dtype=torch.int32, device=dev)
    build.HAMMING.launch(queries.data_ptr(), db.data_ptr(), out.data_ptr(),
                         q, n, ld, words,
                         torch.cuda.current_stream(dev).cuda_stream)
    return out if ld == n else out[:, :n]


class PoolPlan:
    """A serve stage's pool segments (`ref.PoolSegment`), checked once, with
    the kernel's fixed descriptor (table and hot-set pointers, shapes,
    modes, columns) packed once: a call adds its ids, weights, outputs and
    side tables. A segment's own side table (`PoolSegment.side`, the live
    catalog's delta) is checked here and passed on every call; a call may
    give another (the tiered catalog's per-batch overlay). The plan holds
    its tables, so the pointers stay valid."""

    def __init__(self, segments):
        segments = tuple(segments)
        if not 1 <= len(segments) <= _POOL_MAX_SEGMENTS:
            raise ValueError(f"embedding_pool: {len(segments)} segments "
                             f"(1 to {_POOL_MAX_SEGMENTS})")
        dev = segments[0].values.device
        fields = []
        for seg in segments:
            self._check_segment(seg, dev)
            n, d = seg.values.shape
            hot = seg.hot_ids is not None and seg.hot_ids.shape[0] > 0
            fields += [seg.values.data_ptr(), seg.scales.data_ptr(),
                       seg.hot_ids.data_ptr() if hot else 0,
                       seg.hot_rows.data_ptr() if hot else 0, n, d,
                       seg.hot_ids.shape[0] if hot else 0,
                       int(seg.mode == "mean"), seg.column, int(seg.counted),
                       int(seg.masked)]
        self.segments = segments
        self.device = dev
        self._ends = [seg.column + seg.values.shape[1] for seg in segments]
        self._rows = [seg.mode == "rows" for seg in segments]
        self._masked = [seg.masked for seg in segments]
        self._sides = [self._side_fields(seg.side, seg.values.shape[1], dev)
                       for seg in segments]
        # the widest output row the segments write (columns 0..width)
        self.width = max(self._ends)
        self.counted = any(seg.counted for seg in segments)
        self.static = (ctypes.c_int64 * len(fields))(*fields)
        self._call_type = ctypes.c_int64 * (_POOL_CALL_FIELDS * len(segments))

    @staticmethod
    def _check_segment(seg, dev):
        op = "embedding_pool"
        _check(op, seg.values, "values", torch.int8, dev)
        _check(op, seg.scales, "scales", torch.float32, dev)
        n, d = seg.values.shape
        if n < 0 or d < 1 or seg.scales.shape != (n, 1):
            raise ValueError(f"{op}: values {tuple(seg.values.shape)}, "
                             f"scales {tuple(seg.scales.shape)}")
        if seg.mode not in ref.POOL_MODES or seg.column < 0:
            raise ValueError(f"{op}: mode {seg.mode!r}, column {seg.column}")
        if seg.hot_ids is not None and seg.hot_ids.shape[0] > 0:
            _check(op, seg.hot_ids, "hot_ids", torch.int32, dev)
            _check(op, seg.hot_rows, "hot_rows", torch.float32, dev)
            if seg.hot_rows.shape != (seg.hot_ids.shape[0], d):
                raise ValueError(f"{op}: hot_rows "
                                 f"{tuple(seg.hot_rows.shape)}")

    @staticmethod
    def _side_fields(side, d, dev):
        """A side table's four call fields (ids, values, scales, count),
        checked; zeros for None or an empty table."""
        if side is None or side.ids.shape[0] == 0:
            return [0, 0, 0, 0]
        op = "embedding_pool"
        _check(op, side.ids, "side ids", torch.int32, dev)
        _check(op, side.values, "side values", torch.int8, dev)
        _check(op, side.scales, "side scales", torch.float32, dev)
        D = side.ids.shape[0]
        if (side.ids.dim() != 1 or side.values.shape != (D, d)
                or side.scales.shape != (D, 1)):
            raise ValueError(f"{op}: side table ids "
                             f"{tuple(side.ids.shape)}, values "
                             f"{tuple(side.values.shape)}, scales "
                             f"{tuple(side.scales.shape)}")
        return [side.ids.data_ptr(), side.values.data_ptr(),
                side.scales.data_ptr(), D]

    def launch(self, ids, outs, valid=None, weights=None, sides=None):
        """The kernel on this call's tensors -> counters or None. `sides`:
        None, or a `SideTable` or None a segment, replacing the segment's
        own side table for this call."""
        op = "embedding_pool"
        n = len(self.segments)
        if len(ids) != n or len(outs) != n or (
                weights is not None and len(weights) != n) or (
                sides is not None and len(sides) != n):
            raise ValueError(f"{op}: {n} segments, {len(ids)} ids, "
                             f"{len(outs)} outputs")
        vptr = None
        if valid is not None:
            _check(op, valid, "valid", torch.bool, self.device)
            vptr = valid.data_ptr()
        call = []
        checked = None
        for s in range(n):
            x, out = ids[s], outs[s]
            _check(op, x, "ids", torch.int32, self.device)
            if out is not checked:  # a stage's segments share their outputs
                _check(op, out, "out", torch.float32, self.device)
                checked = out
            B, L = x.shape
            if self._rows[s]:  # one slot a row, N rows a batch row
                ok = out.dim() == 3 and out.shape[1] == L
                rows, group, L = B * L, max(L, 1), 1
            else:
                ok = out.dim() == 2
                rows, group = B, 1
            if not ok or out.shape[0] != B or out.shape[-1] < self._ends[s]:
                raise ValueError(f"{op}: out {tuple(out.shape)} for ids "
                                 f"{tuple(x.shape)} (segment {s})")
            if (valid is not None and self._masked[s]
                    and valid.shape != (B,)):
                raise ValueError(f"{op}: valid {tuple(valid.shape)}")
            wptr = 0
            if weights is not None and weights[s] is not None:
                _check(op, weights[s], "weights", torch.float32,
                       self.device)
                if weights[s].shape != x.shape:
                    raise ValueError(f"{op}: weights "
                                     f"{tuple(weights[s].shape)}")
                wptr = weights[s].data_ptr()
            side = self._sides[s]
            if sides is not None and sides[s] is not None:
                side = self._side_fields(sides[s],
                                         self.segments[s].values.shape[1],
                                         self.device)
            if side[3] == 0 and self.segments[s].values.shape[0] == 0:
                raise ValueError(f"{op}: segment {s} has no rows and no "
                                 f"side table")
            call += [x.data_ptr(), wptr, out.data_ptr(), L, rows, group,
                     out.shape[-1], *side]
        counts = (torch.empty(2, dtype=torch.int32, device=self.device)
                  if self.counted else None)
        build.EMBEDDING_POOL.launch(
            self.static, self._call_type(*call), n, vptr,
            None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream(self.device).cuda_stream)
        return counts


def grouped_pool(plan: PoolPlan, ids, outs, valid=None, weights=None,
                 sides=None):
    """Every segment of a stage in one launch: segment s pools `ids[s]`
    ((B, L) int32, -1 padded; (B, N) for a "rows" segment) into columns
    [column, column + d) of each row of `outs[s]` ((B, W) f32, or
    (B, N, W)), in place. `valid` ((B,) bool) masks the batch's padding
    rows in the masked segments; `weights` is None or one (B, L) f32
    tensor (or None) per segment; `sides` is None or one `SideTable` (or
    None: the segment's own) per segment. Returns the (2,) int32 [hits,
    lookups] of the counted segments, or None if none is counted."""
    if use_kernel("embedding_pool", ids[0]):
        return plan.launch(ids, outs, valid, weights, sides)
    return ref.grouped_pool_ref(plan.segments, ids, outs, valid, weights,
                                sides)


def embedding_pool(table_values, table_scales, ids, weights=None):
    """Fused int8 dequant-gather-pool: (n,d) int8 table, (B,L) ids -> (B,d)
    (one "sum" segment of `grouped_pool`)."""
    if not use_kernel("embedding_pool", ids):
        return ref.embedding_pool_ref(table_values, table_scales, ids,
                                      weights)
    out = torch.empty((ids.shape[0], table_values.shape[1]),
                      dtype=torch.float32, device=ids.device)
    PoolPlan([PoolSegment(table_values, table_scales)]).launch(
        [ids], [out], weights=None if weights is None else [weights])
    return out


def hamming_distances(queries, db):
    """(q,w) x (n,w) packed int32 signatures -> (q,n) int32 distances.

    On the card, for n % 4 != 0, the result is the (q, n) view of rows
    padded to a multiple of 4 (the kernel's 16-byte stores): its row stride
    is that padded length, so it is not contiguous. Call `.contiguous()`
    before passing its data pointer on or calling `.view`."""
    if use_kernel("hamming_distances", queries):
        return _hamming_cuda(queries, db)
    return ref.hamming_distance_ref(queries, db)


def streaming_nns(queries, db, *, radius, max_candidates,
                  scan_block=4096, n_valid=None, superblock=None,
                  db_mask=None, prune_blocks=None, prune_block_rows=None):
    """Streaming fixed-radius NNS over the whole DB -> (indices, distances,
    counts), equal bit for bit to the dense threshold + stable top-K.

    `scan_block` sizes the plain version's chunks; `superblock` shrinks the
    plain version's superblocks and caps the kernel's first-pass splits
    (results are invariant to both). `db_mask` (n,) bool marks rows that
    may match; `prune_blocks` (q, nb) bool with `prune_block_rows` rows per
    summary block skips blocks the caller proved empty of matches.
    """
    if use_kernel("streaming_nns", queries):
        return streaming_nns_cuda(
            queries, db, radius=radius, max_candidates=max_candidates,
            n_valid=n_valid, superblock=superblock, db_mask=db_mask,
            prune_blocks=prune_blocks, prune_block_rows=prune_block_rows)
    return ref.streaming_nns_ref(
        queries, db, radius, max_candidates, scan_block=scan_block,
        n_valid=n_valid, superblock=superblock, db_mask=db_mask,
        prune_blocks=prune_blocks, prune_block_rows=prune_block_rows)


def _madvise(arr, advice: str) -> bool:
    """`madvise(advice)` on a memmapped array's mapping; False (a no-op)
    for a plain array or a platform without that advice."""
    mm = getattr(arr, "_mmap", None)
    if mm is None or not hasattr(mmap, advice):
        return False
    try:
        mm.madvise(getattr(mmap, advice))
        return True
    except (ValueError, OSError):
        return False


def madvise_dontneed(arr) -> bool:
    """Drop a memmapped array's resident pages (MADV_DONTNEED); the data is
    never modified, only evicted."""
    return _madvise(arr, "MADV_DONTNEED")


def madvise_random(arr) -> bool:
    """Turn off readahead on a memmapped array (MADV_RANDOM): scattered row
    reads then fault one page each, not up to 128 KB."""
    return _madvise(arr, "MADV_RANDOM")


def streaming_nns_outofcore(queries, db, *, radius, max_candidates,
                            scan_block=4096, n_valid=None, db_mask=None,
                            prune_blocks=None, prune_block_rows=None,
                            chunk_rows=1 << 18):
    """`streaming_nns` over a host-resident (typically `np.memmap`) DB.

    `db` (n, words) uint32 / int32 on the host; `db_mask` and
    `prune_blocks` ((q, nb) bool, True = skip) are host arrays. Summary
    blocks every query prunes are never read. The admitted blocks are
    gathered on the host, `chunk_rows` rows at a time, into pinned staging
    buffers (zero-padded, the padding ineligible) and copied to the
    queries' device without blocking; each chunk is one masked streaming
    scan with `n_valid` (the kernel on a CUDA device), whose rows map back
    to global ids on the device. At most `_OUTOFCORE_INFLIGHT` chunks are
    staged at once: a staging buffer is reused only after its copy's event.
    The chunks' buffers merge with `merge_chunk_buffers`. Returns
    (indices, distances, counts) equal to the resident `streaming_nns`
    with the same mask and a sound prune mask.
    """
    n, words = (int(x) for x in db.shape)
    q = int(queries.shape[0])
    dev = queries.device
    limit = n if n_valid is None else min(int(n_valid), n)
    mask_np = None if db_mask is None else np.asarray(db_mask, bool)
    if prune_blocks is not None:
        br = int(prune_block_rows)
        kept = np.nonzero(~np.asarray(prune_blocks, bool).all(axis=0))[0]
    else:
        br = max(1, int(chunk_rows))
        kept = np.arange(-(-n // br))
    kept = kept[kept * br < limit]
    if kept.size == 0 or limit <= 0:
        return (torch.full((q, max_candidates), -1, dtype=torch.int32,
                           device=dev),
                torch.full((q, max_candidates), BIG_DIST, dtype=torch.int32,
                           device=dev),
                torch.zeros((q,), dtype=torch.int32, device=dev))

    group = max(1, int(chunk_rows) // br)  # admitted blocks a chunk
    cap = group * br
    on_card = dev.type == "cuda"
    src = np.asarray(db).view(np.uint32) if db.dtype == np.int32 else db
    slots = []
    for _ in range(min(_OUTOFCORE_INFLIGHT, -(-kept.size // group))):
        host = [torch.empty(shape, dtype=dtype, pin_memory=on_card)
                for shape, dtype in (((cap, words), torch.int32),
                                     ((cap,), torch.bool),
                                     ((cap,), torch.int32))]
        slots.append([host, None])
    chunks = []
    counts = torch.zeros((q,), dtype=torch.int32, device=dev)
    for i, g in enumerate(range(0, kept.size, group)):
        host, copied = slots[i % len(slots)]
        if copied is not None:
            copied.synchronize()  # its last chunk's copy has left it
        rows_h, elig_h, map_h = host
        blk = kept[g:g + group]
        idx = (blk[:, None] * br + np.arange(br)).reshape(-1)
        m = idx.shape[0]
        within = idx < limit
        idx_c = np.minimum(idx, n - 1)
        rows_np = rows_h.numpy().view(np.uint32)
        np.take(src, idx_c, axis=0, out=rows_np[:m])
        rows_np[m:] = 0
        elig_np = elig_h.numpy()
        elig_np[:m] = within if mask_np is None else within & mask_np[idx_c]
        elig_np[m:] = False
        map_np = map_h.numpy()
        map_np[:m] = idx_c
        map_np[m:] = 0
        rows_d, elig_d, map_d = (t.to(dev, non_blocking=True)
                                 for t in host)
        if on_card:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(dev))
            slots[i % len(slots)][1] = copied
        madvise_dontneed(db)
        lidx, dist, c = streaming_nns(
            queries, rows_d, radius=radius, max_candidates=max_candidates,
            scan_block=scan_block, n_valid=m, db_mask=elig_d)
        gidx = torch.where(lidx >= 0, map_d[lidx.clamp(min=0).long()], -1)
        chunks.append((gidx, dist))
        counts += c
    idx_out, dist_out = merge_chunk_buffers(chunks, max_candidates)
    return idx_out, dist_out, counts


def _flash_cuda(q, k, v, *, causal, scale, q_offset):
    dev = q.device
    op = "flash_attention"
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{op}: dtype {q.dtype} (float32 or bfloat16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(op, t, name, q.dtype, dev)
    bh, sq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"{op}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"{op}: head dim {d} not in {_FLASH_HEAD_DIMS}")
    if -(-sq // 64) > 65535:
        raise ValueError(f"{op}: {sq} query rows exceed the grid")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError(f"{op}: q, k, v and out must be 16-byte aligned "
                         f"(cp.async copies 16 bytes)")
    build.FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
        k.shape[1], d, _FLASH_DTYPES[q.dtype], scale, int(causal),
        q_offset, torch.cuda.current_stream(dev).cuda_stream)
    return out


def flash_attention_bhsd(q, k, v, *, causal=True, scale=None, q_offset=0):
    """(bh, sq, d) x (bh, sk, d) attention -> (bh, sq, d) in q's dtype, as
    `repro`'s `flash_attention_pallas`; `q_offset` places q[0] in the kv
    sequence for the causal mask."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if use_kernel("flash_attention", q):
        return _flash_cuda(q, k, v, causal=causal, scale=scale,
                           q_offset=int(q_offset))
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)


def flash_attention(q, k, v, *, causal=True, scale=None):
    """(b, h, s, d) attention -> (b, h, sq, d); the flash kernel on the
    card, its plain version on the CPU."""
    b, h, sq, d = q.shape
    out = flash_attention_bhsd(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, k.shape[2], d).contiguous(),
        v.reshape(b * h, v.shape[2], d).contiguous(),
        causal=causal, scale=scale)
    return out.reshape(b, h, sq, d)


def _int8_matmul_cuda(x, w, x_scale, w_scale):
    dev = x.device
    op = "int8_matmul"
    _check(op, x, "x", torch.int8, dev)
    _check(op, w, "w", torch.int8, dev)
    _check(op, x_scale, "x_scale", torch.float32, dev)
    _check(op, w_scale, "w_scale", torch.float32, dev)
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or x_scale.shape != (m, 1) or w_scale.shape != (1, n):
        raise ValueError(f"{op}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"x_scale {tuple(x_scale.shape)}, "
                         f"w_scale {tuple(w_scale.shape)}")
    if -(-m // 128) > 65535:
        raise ValueError(f"{op}: {m} rows exceed the grid")
    if k > _INT8_MAX_K:
        raise ValueError(f"{op}: k = {k} > {_INT8_MAX_K}: the int32 sum "
                         f"could overflow")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    build.INT8_MATMUL.launch(
        x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, n, k, torch.cuda.current_stream(dev).cuda_stream)
    return out


def int8_matmul(x, w, x_scale, w_scale):
    """int8 (m,k) @ int8 (k,n) with per-row (m,1) / per-column (1,n) f32
    scales -> f32 (m,n), equal bit for bit to the plain version."""
    if use_kernel("int8_matmul", x):
        return _int8_matmul_cuda(x, w, x_scale, w_scale)
    return ref.int8_matmul_ref(x, w, x_scale, w_scale)
