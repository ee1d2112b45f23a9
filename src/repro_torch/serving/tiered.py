"""Frequency-tiered out-of-core catalog: disk -> int8 RAM pool -> f32 hot
(mirrors `repro/serving/tiered.py`).

  * the **cold base shard** (`BaseShard`): the whole int8 catalog (values,
    scales, LSH signatures) in memory-mapped files; the filtering scan
    reaches it through `core.nns.out_of_core_nns`, which reads only the
    summary blocks some query admits;
  * the **int8 pool**: a host byte-cache of the P most looked-up rows, so
    popular lookups never read the disk; its bytes are the shard's bytes;
  * the **f32 hot cache**: the engine's `HotRowCache` on the card, the top
    H <= P of the same ranking (hot is a prefix of the pool);
  * a bounded **delta shard** (`serving/catalog.py`'s update rule) holds
    pending upserts; touched ids leave both caches at once.

A served id resolves delta > pool > disk on the host: per batch the host
builds a sorted overlay of the bytes every requested id resolves to,
sends it through pinned buffers, and the lookup and rank stages are each
one grouped-pool launch that takes the overlay as the item segment's side
table, a segment with no base rows behind it (an id the overlay lacks
reads zeros; the hot cache is probed as usual). Results and cache
counters equal, bit for bit, those of the all-RAM engine over the same
state (`to_ram_engine`) and of `rebuild_reference`.

`rebalance` recomputes the pool and hot tiers from the measured lookup
frequencies (frequency descending, ties by ascending id); `compact`
streams base + delta into a new shard epoch, as `catalog.materialize`
folds them, and rebalances against it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.core.nns import (
    EMPTY_ID,
    SUMMARY_BLOCK_ROWS,
    BlockSummary,
    build_block_summary,
    delta_scan,
    merge_delta_candidates,
    out_of_core_nns,
    update_block_summary,
)
from repro_torch.core.lsh import lsh_signature
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.kernels.ops import SideTable, madvise_dontneed, madvise_random
from repro_torch.serving.batcher import HostCopy, stage_batch
from repro_torch.serving.catalog import (
    DeltaFullError,
    _delta_from_numpy,
    _delta_numpy,
    _zero_row,
    empty_delta,
    fold_updates,
    quantize_updates,
)
from repro_torch.serving.hot_cache import (
    HotRowCache,
    invalidate_rows,
    top_ids_by_freq,
)
from repro_torch.serving.recsys_engine import (
    ServeResult,
    _features,
    _rank_stage,
)
from repro_torch.utils import to_device

_META = "meta.json"
_FILES = {"values": ("values.int8.bin", np.int8),
          "scales": ("scales.f32.bin", np.float32),
          "sigs": ("sigs.u32.bin", np.uint32)}
_SUMMARY_FIELDS = ("or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive")


# ---------------------------------------------------------------------------
# the cold base shard: memmapped (values, scales, sigs) and its sidecars
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BaseShard:
    """One read-only on-disk catalog epoch, opened as memmaps: `values`
    (n, d) int8, `scales` (n, 1) f32, `sigs` (n, words) uint32. Reading
    them faults in only the pages touched."""

    directory: str
    n: int
    d: int
    words: int
    values: np.memmap
    scales: np.memmap
    sigs: np.memmap


class BaseShardWriter:
    """Chunked writer of a `BaseShard` epoch directory: `write(lo, values,
    scales, sigs)` scatters one chunk of rows; `finish(alive=, summary=)`
    flushes the maps and writes the alive mask, the block summary (so an
    open never reads every signature page) and the meta file."""

    def __init__(self, directory: str, n: int, d: int, words: int):
        os.makedirs(directory, exist_ok=True)
        self.directory, self.n, self.d, self.words = directory, n, d, words
        shapes = {"values": (n, d), "scales": (n, 1), "sigs": (n, words)}
        self._maps = {
            key: np.memmap(os.path.join(directory, fname), dtype=dtype,
                           mode="w+", shape=shapes[key])
            for key, (fname, dtype) in _FILES.items()}

    def write(self, lo: int, values, scales, sigs) -> None:
        hi = lo + len(values)
        self._maps["values"][lo:hi] = np.asarray(values, np.int8)
        self._maps["scales"][lo:hi] = np.asarray(
            scales, np.float32).reshape(-1, 1)
        self._maps["sigs"][lo:hi] = np.asarray(sigs).view(np.uint32)

    def finish(self, alive=None, summary: BlockSummary | None = None) -> None:
        for m in self._maps.values():
            m.flush()
        if alive is None:
            alive = np.ones((self.n,), bool)
        np.save(os.path.join(self.directory, "alive.npy"),
                np.asarray(alive, bool))
        if summary is not None:
            np.savez(os.path.join(self.directory, "summary.npz"),
                     **{f: getattr(summary, f).cpu().numpy()
                        for f in _SUMMARY_FIELDS},
                     block_rows=np.int64(summary.block_rows))
        meta = {"n": self.n, "d": self.d, "words": self.words, "version": 1}
        with open(os.path.join(self.directory, _META), "w") as f:
            json.dump(meta, f)
        self._maps = {}


def write_base_shard(directory: str, values, scales, sigs, *, alive=None,
                     summary: BlockSummary | None = None) -> None:
    """One-shot shard write; large catalogs stream chunks through
    `BaseShardWriter`."""
    values = np.asarray(values)
    w = BaseShardWriter(directory, values.shape[0], values.shape[1],
                        np.asarray(sigs).shape[1])
    w.write(0, values, scales, sigs)
    w.finish(alive=alive, summary=summary)


def pread_rows(mm: np.memmap, ids) -> np.ndarray:
    """Rows `ids` of a memmap read with `os.pread`, not through the mapping
    (a scattered fault maps its whole fault-around window); duplicate ids
    are read once. A plain array is indexed directly."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    fname = getattr(mm, "filename", None)
    if fname is None:
        return np.asarray(mm[ids])
    uniq, inv = np.unique(ids, return_inverse=True)
    row = int(np.prod(mm.shape[1:], dtype=np.int64)) * mm.dtype.itemsize
    base = int(getattr(mm, "offset", 0))
    out = np.empty((uniq.size,) + mm.shape[1:], mm.dtype)
    flat = out.reshape(uniq.size, -1).view(np.uint8)
    fd = os.open(fname, os.O_RDONLY)
    try:
        for i, r in enumerate(uniq):
            flat[i] = np.frombuffer(
                os.pread(fd, row, base + int(r) * row), np.uint8)
    finally:
        os.close(fd)
    return out[inv.reshape(-1)]


def open_base_shard(directory: str):
    """-> (BaseShard, alive (n,) bool array, BlockSummary on the CPU or
    None). The memmaps open read-only with readahead off."""
    with open(os.path.join(directory, _META)) as f:
        meta = json.load(f)
    n, d, words = meta["n"], meta["d"], meta["words"]
    shapes = {"values": (n, d), "scales": (n, 1), "sigs": (n, words)}
    maps = {key: np.memmap(os.path.join(directory, fname), dtype=dtype,
                           mode="r", shape=shapes[key])
            for key, (fname, dtype) in _FILES.items()}
    for m in maps.values():
        madvise_random(m)
    shard = BaseShard(directory=directory, n=n, d=d, words=words, **maps)
    alive = np.load(os.path.join(directory, "alive.npy"))
    summary = None
    spath = os.path.join(directory, "summary.npz")
    if os.path.exists(spath):
        z = np.load(spath)
        summary = BlockSummary(
            *to_device([z[f].view(np.int32) if z[f].dtype == np.uint32
                        else z[f] for f in _SUMMARY_FIELDS], "cpu"),
            block_rows=int(z["block_rows"]))
    return shard, alive, summary


def _summary_to(summary: BlockSummary, device) -> BlockSummary:
    return BlockSummary(*(getattr(summary, f).to(device)
                          for f in _SUMMARY_FIELDS),
                        block_rows=summary.block_rows)


def _staged(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` through a pinned buffer (non-blocking)."""
    return stage_batch({"a": np.ascontiguousarray(a)}, device)["a"]


# ---------------------------------------------------------------------------
# the tiered catalog
# ---------------------------------------------------------------------------
def _refuse_mesh(engine) -> None:
    if engine.nns_mesh is not None:
        raise ValueError("TieredCatalog serving is host-driven; "
                         "use an unsharded engine")


class TieredCatalog:
    """Host-driven tiered serving over a memmapped base shard.

    Holds the cold `BaseShard`, the int8 pool and f32 hot tiers, the
    bounded delta shard, the block summary and alive mask, and the measured
    lookup frequencies. `serve` equals `to_ram_engine().serve` bit for bit,
    cache counters included.

    `inner` is a `RecSysEngine` whose user-side tensors (feature tables,
    MLPs, genre table, LSH projection, hot caches) are real and whose item
    table has no rows: item bytes live on disk, in the pool or in the
    delta, and reach the pool kernel as a per-batch side table.
    """

    def __init__(self, directory: str, shard: BaseShard, inner, *,
                 alive, summary, pool_rows: int, item_freqs=None,
                 delta_capacity: int = 1024, auto_compact: bool = True,
                 registry=None):
        _refuse_mesh(inner)
        self.directory = directory
        self.base = shard
        self.inner = inner
        self.alive = np.asarray(alive, bool).copy()
        self.summary = _summary_to(summary, inner.device)
        self.auto_compact = auto_compact
        self.epoch = 0
        n = shard.n
        # an (n,) int64 writable array is adopted (observe() counts into
        # it in place); anything else is copied
        freqs_in = None if item_freqs is None else np.asarray(item_freqs)
        if (freqs_in is not None and freqs_in.shape == (n,)
                and freqs_in.dtype == np.int64 and freqs_in.flags.writeable):
            self.item_freqs = freqs_in
        else:
            self.item_freqs = np.zeros((n,), np.int64)
            if freqs_in is not None:
                m = min(len(freqs_in), n)
                self.item_freqs[:m] = freqs_in[:m]
        self.n_observed = int(self.item_freqs.sum())
        self._set_delta(_delta_numpy(empty_delta(delta_capacity, shard.d,
                                                 shard.words)))
        self._pool_capacity = int(pool_rows)
        hot_cap = inner.item_hot.capacity if inner.item_hot is not None \
            else 0
        if hot_cap > self._pool_capacity:
            raise ValueError(
                f"hot capacity {hot_cap} exceeds pool capacity "
                f"{self._pool_capacity}: the hot tier must be a subset "
                f"of the pool")
        self.pool_ids = np.zeros((0,), np.int32)
        self.pool_vals = np.zeros((0, shard.d), np.int8)
        self.pool_scales = np.zeros((0, 1), np.float32)
        self.rebalance()
        # telemetry (host counters; never change results)
        self.n_compactions = 0
        self.pool_hits = 0
        self.delta_hits = 0
        self.disk_rows = 0
        self.last_compact_s = 0.0
        self.registry = registry
        if registry is not None:
            registry.register_collector(self._collect)

    def _collect(self, reg) -> None:
        """Snapshot-time collector: tier residency and hit-mix gauges."""
        reg.gauge("tiered.epoch", self.epoch)
        reg.gauge("tiered.compactions", self.n_compactions)
        reg.gauge("tiered.last_compact_s", self.last_compact_s)
        reg.gauge("tiered.pool_hits", self.pool_hits)
        reg.gauge("tiered.delta_hits", self.delta_hits)
        reg.gauge("tiered.disk_rows", self.disk_rows)
        reg.gauge("tiered.pool_rows", int(self.pool_ids.size))
        reg.gauge("tiered.delta_pending", self.n_pending)
        reg.gauge("tiered.resident_bytes", self.resident_bytes())

    def _set_delta(self, delta_np) -> None:
        """The delta shard: host arrays for the byte resolution, and its
        tensors on the card for the delta scan."""
        self._delta_np = delta_np
        self.delta = _delta_from_numpy(*delta_np, self.device)

    @property
    def device(self) -> torch.device:
        return self.inner.device

    # -- construction --------------------------------------------------
    @classmethod
    def open(cls, directory: str, engine, *, pool_rows: int = 0,
             item_freqs=None, delta_capacity: int = 1024,
             auto_compact: bool = True, registry=None) -> "TieredCatalog":
        """Open the latest shard epoch under `directory` and serve it.
        `engine` gives the user-side model state, the knobs and the hot
        capacity; its item table and signatures are not used."""
        epochs = sorted((e for e in os.listdir(directory)
                         if e.startswith("epoch_")),
                        key=lambda e: int(e.split("_")[1]))
        if not epochs:
            raise FileNotFoundError(f"no epoch_* shard under {directory}")
        shard, alive, summary = open_base_shard(
            os.path.join(directory, epochs[-1]))
        if summary is None:
            summary = build_block_summary(shard.sigs, SUMMARY_BLOCK_ROWS,
                                          db_mask=alive)
        dev = engine.device
        hot_cap = engine.item_hot.capacity if engine.item_hot is not None \
            else 0
        inner = dataclasses.replace(
            engine,
            item_table_q=QuantizedTensor(
                values=torch.zeros((0, shard.d), dtype=torch.int8,
                                   device=dev),
                scales=torch.zeros((0, 1), dtype=torch.float32, device=dev)),
            item_sigs=torch.zeros((1, shard.words), dtype=torch.int32,
                                  device=dev),
            item_hot=HotRowCache(
                hot_ids=torch.full((hot_cap,), EMPTY_ID, dtype=torch.int32,
                                   device=dev),
                hot_rows=torch.zeros((hot_cap, shard.d), dtype=torch.float32,
                                     device=dev),
                capacity=hot_cap) if hot_cap else engine.item_hot,
            item_mask=None, delta=None, block_summary=None)
        cat = cls(directory, shard, inner, alive=alive, summary=summary,
                  pool_rows=pool_rows, item_freqs=item_freqs,
                  delta_capacity=delta_capacity, auto_compact=auto_compact,
                  registry=registry)
        cat.epoch = int(epochs[-1].split("_")[1])
        return cat

    @classmethod
    def from_engine(cls, engine, directory: str, *, pool_rows: int = 0,
                    item_freqs=None, delta_capacity: int = 1024,
                    auto_compact: bool = True, registry=None
                    ) -> "TieredCatalog":
        """Spill an all-RAM engine's item table (its base; a live engine's
        pending delta is not part of it) to an epoch-0 shard under
        `directory` and serve it tiered."""
        _refuse_mesh(engine)
        n = int(engine.item_table_q.values.shape[0])
        sigs = engine.item_sigs[:n].cpu().numpy().view(np.uint32)
        alive = (np.ones((n,), bool) if engine.item_mask is None
                 else engine.item_mask[:n].cpu().numpy())
        summary = build_block_summary(sigs, SUMMARY_BLOCK_ROWS,
                                      db_mask=alive)
        write_base_shard(
            os.path.join(directory, "epoch_0"),
            engine.item_table_q.values.cpu().numpy(),
            engine.item_table_q.scales.cpu().numpy(), sigs,
            alive=alive, summary=summary)
        return cls.open(directory, engine, pool_rows=pool_rows,
                        item_freqs=item_freqs, delta_capacity=delta_capacity,
                        auto_compact=auto_compact, registry=registry)

    # -- tier mechanics ------------------------------------------------
    def _resolve_bytes(self, ids: np.ndarray):
        """Host resolution of `ids` -> (present, values, scales) through
        delta > pool > disk. A tombstoned base id still resolves to its
        base bytes, as the all-RAM engine's cold gather reads them."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        m = ids.size
        vals = np.zeros((m, self.base.d), np.int8)
        scales = np.zeros((m, 1), np.float32)
        valid = ids >= 0
        safe = np.maximum(ids, 0)
        in_delta = np.zeros(m, bool)
        dids, dvals, dscales, _ = self._delta_np
        if dids.size:
            pos = np.clip(np.searchsorted(dids, safe), 0, dids.size - 1)
            in_delta = valid & (dids[pos] == ids)
            if in_delta.any():
                vals[in_delta] = dvals[pos[in_delta]]
                scales[in_delta] = dscales[pos[in_delta]]
        in_pool = np.zeros(m, bool)
        if self.pool_ids.size:
            ppos = np.clip(np.searchsorted(self.pool_ids, safe), 0,
                           self.pool_ids.size - 1)
            in_pool = valid & ~in_delta & (self.pool_ids[ppos] == ids)
            if in_pool.any():
                vals[in_pool] = self.pool_vals[ppos[in_pool]]
                scales[in_pool] = self.pool_scales[ppos[in_pool]]
        in_disk = valid & ~in_delta & ~in_pool & (ids < self.base.n)
        if in_disk.any():
            didx = ids[in_disk]
            vals[in_disk] = pread_rows(self.base.values, didx)
            scales[in_disk] = pread_rows(self.base.scales, didx)
        self.delta_hits += int(in_delta.sum())
        self.pool_hits += int(in_pool.sum())
        self.disk_rows += int(in_disk.sum())
        return (in_delta | in_pool | in_disk), vals, scales

    def _build_overlay(self, ids) -> SideTable:
        """ids (any int shape) -> the sorted byte overlay on the card (one
        slot an id, `EMPTY_ID` for an id with no row), sent through pinned
        buffers; the pool kernel's side table for this batch."""
        flat = np.asarray(ids, np.int64).reshape(-1)
        present, vals, scales = self._resolve_bytes(flat)
        ov_ids = np.where(present, flat, np.int64(EMPTY_ID)).astype(np.int32)
        order = np.argsort(ov_ids, kind="stable")
        self.last_staged_bytes = int(ov_ids.nbytes + vals.nbytes
                                     + scales.nbytes)
        return SideTable(ids=_staged(ov_ids[order], self.device),
                         values=_staged(vals[order], self.device),
                         scales=_staged(scales[order], self.device))

    def rebalance(self) -> None:
        """Recompute pool and hot membership from `item_freqs`: pool = the
        top-P alive base rows by (frequency desc, id asc), hot = the top-H
        prefix of the same ranking. Pending delta ids and tombstoned rows
        are not eligible. Residency moves; results do not."""
        eligible = self.alive.copy()
        dids = self._delta_np[0]
        dids = dids[dids != EMPTY_ID]
        eligible[dids[dids < self.base.n]] = False
        ranked = top_ids_by_freq(self.item_freqs[: self.base.n],
                                 self._pool_capacity, eligible=eligible)
        order = np.argsort(ranked, kind="stable")
        self.pool_ids = ranked[order].astype(np.int32)
        self.pool_vals = pread_rows(self.base.values, self.pool_ids)
        self.pool_scales = pread_rows(self.base.scales, self.pool_ids)
        cache = self.inner.item_hot
        if cache is not None and cache.capacity:
            hot = np.sort(ranked[: cache.capacity]).astype(np.int32)
            hot_ids = np.full((cache.capacity,), EMPTY_ID, np.int32)
            hot_ids[: hot.size] = hot
            rows = np.zeros((cache.capacity, self.base.d), np.float32)
            if hot.size:  # `dequantize_rowwise`'s one rounded multiply
                hpos = np.searchsorted(self.pool_ids, hot)
                rows[: hot.size] = (self.pool_vals[hpos].astype(np.float32)
                                    * self.pool_scales[hpos])
            self.inner = dataclasses.replace(
                self.inner, item_hot=HotRowCache(
                    hot_ids=torch.from_numpy(hot_ids).to(self.device),
                    hot_rows=torch.from_numpy(rows).to(self.device),
                    capacity=cache.capacity))

    def observe(self, ids) -> None:
        """Count served lookups (`LiveCatalog.observe`'s rule)."""
        ids = np.asarray(ids).reshape(-1)
        ids = ids[(ids >= 0) & (ids < EMPTY_ID)]
        if not ids.size:
            return
        hi = int(ids.max()) + 1
        if hi > self.item_freqs.shape[0]:
            grown = np.zeros((hi,), np.int64)
            grown[: self.item_freqs.shape[0]] = self.item_freqs
            self.item_freqs = grown
        np.add.at(self.item_freqs, ids, 1)
        self.n_observed += int(ids.size)

    # -- serving -------------------------------------------------------
    def serve(self, batch: dict) -> ServeResult:
        """Serve one padded batch (`RecSysEngine.serve`'s schema) from the
        tiered store; equal to `to_ram_engine().serve(batch)` bit for bit.

        The history overlay goes out with the batch; the lookup stage is
        one pool launch; the base scans out of core (`out_of_core_nns`),
        the delta dense, and the two merge; the candidate ids come back
        once (pinned buffer and event) to build the rank overlay; the rank
        stage is one pool launch. The final ids come back for the
        frequency counters."""
        inner = self.inner
        hist_np = np.asarray(batch["history"])
        b = stage_batch({k: np.asarray(v, bool if k == "valid" else np.int32)
                         for k, v in batch.items()}, self.device)
        n_feats = len(inner.cfg.user_features)
        ov = self._build_overlay(hist_np)
        staged = self.last_staged_bytes
        u, pooled, stats = _features(inner, b, sides=[None] * n_feats + [ov])
        q_sigs = lsh_signature(u, inner.lsh_proj)
        base = out_of_core_nns(
            q_sigs, self.base.sigs, inner.radius, inner.n_candidates,
            db_mask=self.alive, scan_block=inner.scan_block,
            summary=self.summary, prune=inner.prune)
        pending = delta_scan(q_sigs, self.delta.sigs, self.delta.ids,
                             inner.radius, inner.n_candidates)
        nns = merge_delta_candidates(base, pending, inner.n_candidates)
        (cand_np,) = HostCopy([nns.indices]).numpy()
        ov2 = self._build_overlay(cand_np)
        self.last_staged_bytes += staged
        final, top, stats = _rank_stage(inner, b, nns.indices, u, pooled,
                                        stats, sides=[ov2, None])
        (final_np,) = HostCopy([final]).numpy()
        self.observe(np.concatenate([hist_np.reshape(-1).astype(np.int64),
                                     final_np.reshape(-1).astype(np.int64)]))
        # the tiers are the cache: drop the base pages this batch's cold
        # rows faulted in, so residency stays that of a batch
        for m in (self.base.values, self.base.scales):
            madvise_dontneed(m)
        return ServeResult(items=final, topk=top, nns=nns,
                           cost=inner.query_cost(), stats=stats)

    # -- mutation ------------------------------------------------------
    def apply_updates(self, upsert_ids=None, upsert_rows=None,
                      delete_ids=None) -> None:
        """`catalog.engine_apply_updates`' rule on the tiered state: the
        delta takes the updates, touched base rows are tombstoned and leave
        the pool and the hot cache, touched summary blocks are recomputed.
        A full delta forces a compaction (unless `auto_compact=False`)."""
        try:
            self._apply_updates(upsert_ids, upsert_rows, delete_ids)
        except DeltaFullError:
            if not self.auto_compact:
                raise
            self.compact()
            self._apply_updates(upsert_ids, upsert_rows, delete_ids)

    def upsert(self, ids, rows) -> None:
        self.apply_updates(upsert_ids=ids, upsert_rows=rows)

    def delete(self, ids) -> None:
        self.apply_updates(delete_ids=ids)

    def _apply_updates(self, upsert_ids, upsert_rows, delete_ids) -> None:
        n_base = self.base.n
        mask = self.alive.copy()
        new_np, touched = fold_updates(
            self._delta_np, n_base, mask,
            lambda rows: quantize_updates(self.inner, rows), upsert_ids,
            upsert_rows, delete_ids)
        base_touched = [g for g in touched if g < n_base]
        if base_touched:
            self.summary = update_block_summary(self.summary, self.base.sigs,
                                                mask, base_touched)
        self.alive = mask
        self._set_delta(new_np)
        if touched:
            t = np.asarray(touched)
            self.inner = dataclasses.replace(
                self.inner, item_hot=invalidate_rows(self.inner.item_hot, t))
            keep = ~np.isin(self.pool_ids, t)
            if not keep.all():
                self.pool_ids = self.pool_ids[keep]
                self.pool_vals = self.pool_vals[keep]
                self.pool_scales = self.pool_scales[keep]

    # -- compaction and migration --------------------------------------
    def compact(self, chunk_rows: int = 1 << 18) -> None:
        """Stream base + delta into a new shard epoch (`catalog.materialize`
        row for row: base bytes verbatim, delta rows scattered in, id gaps
        the canonical zero row and dead), a chunk at a time; then a cold
        summary, an empty delta, and `rebalance` against the new epoch."""
        t0 = time.perf_counter()
        n_base, d, words = self.base.n, self.base.d, self.base.words
        dids_np, dvals_all, dscales_all, dsigs_all = self._delta_np
        live = np.nonzero(dids_np != EMPTY_ID)[0]
        gids = dids_np[live].astype(np.int64)
        n_total = int(max(n_base, (gids.max() + 1) if len(gids) else 0))
        zero_q, zero_sig = _zero_row(self.inner, d)
        zero_v = zero_q.values.cpu().numpy()
        zero_s = zero_q.scales.cpu().numpy()
        zero_g = zero_sig.cpu().numpy().view(np.uint32)
        dvals, dscales = dvals_all[live], dscales_all[live]
        dsigs = dsigs_all[live].view(np.uint32)

        new_dir = os.path.join(self.directory, f"epoch_{self.epoch + 1}")
        writer = BaseShardWriter(new_dir, n_total, d, words)
        alive_new = np.zeros((n_total,), bool)
        alive_new[:n_base] = self.alive[:n_base]
        alive_new[gids] = True
        for lo in range(0, n_total, chunk_rows):
            hi = min(lo + chunk_rows, n_total)
            b = max(0, min(hi, n_base) - lo)  # base rows in this chunk
            vals = np.concatenate([self.base.values[lo:lo + b],
                                   np.broadcast_to(zero_v, (hi - lo - b, d))])
            scales = np.concatenate([self.base.scales[lo:lo + b],
                                     np.broadcast_to(zero_s,
                                                     (hi - lo - b, 1))])
            sigs = np.concatenate([self.base.sigs[lo:lo + b],
                                   np.broadcast_to(zero_g,
                                                   (hi - lo - b, words))])
            sel = (gids >= lo) & (gids < hi)
            if sel.any():
                vals[gids[sel] - lo] = dvals[sel]
                scales[gids[sel] - lo] = dscales[sel]
                sigs[gids[sel] - lo] = dsigs[sel]
            writer.write(lo, vals, scales, sigs)
        br = self.summary.block_rows
        writer._maps["sigs"].flush()
        summary = build_block_summary(writer._maps["sigs"], br,
                                      db_mask=alive_new)
        writer.finish(alive=alive_new, summary=summary)

        self.base = open_base_shard(new_dir)[0]
        self.alive = alive_new
        self.summary = _summary_to(summary, self.device)
        self._set_delta(_delta_numpy(empty_delta(len(dids_np), d, words)))
        self.epoch += 1
        self.n_compactions += 1
        freqs = np.zeros((self.base.n,), np.int64)
        m = min(self.item_freqs.shape[0], self.base.n)
        freqs[:m] = self.item_freqs[:m]
        self.item_freqs = freqs
        self.rebalance()
        self.last_compact_s = time.perf_counter() - t0
        if self.registry is not None:
            self.registry.observe("tiered.compact_pause_s",
                                  self.last_compact_s)
            self.registry.event("compact", epoch=self.epoch,
                                pause_s=self.last_compact_s,
                                n_items=self.n_items,
                                pool_rows=int(self.pool_ids.size))

    # -- persistence ---------------------------------------------------
    def _sidecar_state(self) -> dict:
        """What the epoch shard does not hold: the pending delta, the
        post-epoch tombstones and the frequency counters (pool, hot and
        summary are re-derived from them at restore)."""
        return {"delta": self.delta, "alive": self.alive,
                "item_freqs": self.item_freqs,
                "n_observed": np.int64(self.n_observed)}

    def snapshot(self, directory) -> None:
        """Epoch-numbered snapshot of the sidecar state through the
        checkpointer, so a restored catalog resumes with the ranking it
        had measured."""
        from repro_torch.checkpoint import checkpointer

        checkpointer.save(directory, self.epoch, self._sidecar_state())

    def restore(self, directory) -> None:
        """Restore the latest committed sidecar snapshot (its epoch must be
        the opened shard's) and re-derive summary, pool and hot tiers."""
        from repro_torch.checkpoint import checkpointer

        step = checkpointer.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed snapshot in {directory}")
        if step != self.epoch:
            raise ValueError(
                f"snapshot epoch {step} does not match the opened shard "
                f"epoch {self.epoch}; open the matching epoch_{step} "
                f"shard first")
        state = checkpointer.restore(directory, step, self._sidecar_state())
        self._set_delta(_delta_numpy(state["delta"]))
        self.alive = np.asarray(state["alive"], bool).copy()
        self.item_freqs = np.asarray(state["item_freqs"], np.int64).copy()
        self.n_observed = int(state["n_observed"])
        self.summary = _summary_to(build_block_summary(
            self.base.sigs, self.summary.block_rows, db_mask=self.alive),
            self.device)
        self.rebalance()

    # -- introspection and oracles -------------------------------------
    @property
    def n_pending(self) -> int:
        return int((self._delta_np[0] != EMPTY_ID).sum())

    @property
    def n_items(self) -> int:
        return int(self.alive.sum()) + self.n_pending

    def resident_bytes(self) -> int:
        """Bytes the item tiers pin (pool, hot cache, summary, alive mask):
        the residency the memmapped base shard does not cost."""
        pool = (self.pool_vals.nbytes + self.pool_scales.nbytes
                + self.pool_ids.nbytes)
        cache = self.inner.item_hot
        hot = 0 if cache is None else (
            cache.hot_rows.nbytes + cache.hot_ids.nbytes)
        summ = sum(getattr(self.summary, f).nbytes for f in _SUMMARY_FIELDS)
        return int(pool + hot + summ + self.alive.nbytes)

    def stats(self) -> dict:
        return {"epoch": self.epoch, "n_items": self.n_items,
                "n_pending": self.n_pending,
                "n_compactions": self.n_compactions,
                "pool_rows": int(self.pool_ids.size),
                "hot_rows": 0 if self.inner.item_hot is None else
                int(self.inner.item_hot.capacity),
                "pool_hits": self.pool_hits, "delta_hits": self.delta_hits,
                "disk_rows": self.disk_rows,
                "resident_bytes": self.resident_bytes()}

    def to_ram_engine(self):
        """The all-RAM live engine over this catalog's exact state (the
        base loaded from the shard; the same delta, mask, summary and hot
        cache): the bit-match comparator. O(n) memory on the card."""
        dev = self.device
        table = QuantizedTensor(
            values=torch.from_numpy(np.array(self.base.values)).to(dev),
            scales=torch.from_numpy(np.array(self.base.scales)).to(dev))
        return dataclasses.replace(
            self.inner, item_table_q=table,
            item_sigs=torch.from_numpy(
                np.array(self.base.sigs).view(np.int32)).to(dev),
            item_mask=torch.from_numpy(self.alive.copy()).to(dev),
            delta=self.delta, block_summary=self.summary)

    def rebuild_reference(self):
        """`catalog.rebuild_reference` over `to_ram_engine()`: the
        from-scratch oracle pinning this catalog's surviving hot set."""
        from repro_torch.serving.catalog import rebuild_reference

        return rebuild_reference(self.to_ram_engine())

