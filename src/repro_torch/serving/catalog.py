"""Live catalog: a delta shard and tombstones over a read-only base
(mirrors `repro/serving/catalog.py`).

A catalog churns while traffic is live: items are added, retired and
re-embedded. The base epoch (`item_table_q`, `item_sigs`) stays
read-only; updates land in a bounded delta shard (`DeltaShard`: int8
rows, scales, signatures and global ids, kept sorted by id with
`EMPTY_ID` free slots), and base rows that were deleted or overwritten
are tombstoned in the engine's `item_mask`. Serving resolves item rows
through the delta first (the pool kernel's side table) and scans base +
delta (`core.nns.delta_aware_nns`), and the results equal, bit for bit,
those of an engine rebuilt from scratch over the final table
(`rebuild_reference`). `compact` folds the delta into a new base epoch.

Every update builds a new engine with new tensors; nothing a bucket
already queued on the card reads is changed in place, so an attached
front-end swaps engines between buckets (`LiveCatalog.attach`).

Catalog content is canonically quantized: `upsert` quantizes f32 rows
once (int8 + scale, as the build does) and signs the dequantized rows, so
a row's image is the same whether it entered at build time, through the
delta, or through a compaction. The bookkeeping runs on the host with
numpy; the tables stay on the engine's device.

A bank-sharded engine (`RecSysEngine.shard`) holds one bank of the
signatures, mask and summary a rank. Reads of the global rows go through
`global_rows` (an all-gather over the bank axis); an update writes the
rank's bank of the new mask and recomputes its own summary blocks, and a
compaction re-shards the folded table onto the engine's mesh. Every rank
applies the same updates in the same order. Attached to a concurrent
front-end over a mesh engine, every call that runs a collective or
publishes (`apply_updates`, `compact`, `refresh_model`, `n_items`,
`snapshot`, `restore`) runs inside the front-end's pause window
(`ConcurrentFrontend.paused`), so its collectives never interleave with
a serve's on any rank.

A snapshot does not depend on the layout that wrote it: it holds the
engine in its unsharded layout (`unshard`: a bank-sharded engine's
signatures and mask gathered in bank order, pad rows dropped) and
restores onto any template, sharded or not. Its leaves are the unsharded
catalog's after the same churn but for `block_summary`: a bank-sharded
engine keeps a summary a bank (at its own block rows, or none where the
banks do not hold whole blocks), so the snapshot holds a summary built
cold over the gathered rows at the banks' block rows
(`SUMMARY_BLOCK_ROWS` where they have none). It equals the unsharded
catalog's where those block rows are the same: a cold build and the
exact per-block updates agree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.lsh import lsh_signature
from repro_torch.core.nns import (
    EMPTY_ID,
    SUMMARY_BLOCK_ROWS,
    build_block_summary,
    update_block_summary,
)
from repro_torch.core.quantization import (
    QuantizedTensor,
    dequantize_rowwise,
    quantize_rowwise,
)
from repro_torch.serving.hot_cache import (
    cached_rows,
    invalidate_rows,
    pin_rows,
    top_ids_by_freq,
)
from repro_torch.utils import all_gather_axis


class DeltaFullError(RuntimeError):
    """The bounded delta shard cannot hold the requested updates."""


@dataclasses.dataclass(frozen=True)
class DeltaShard:
    """Bounded overlay on a read-only base item table.

    Live slots form an ascending-by-id prefix; free slots hold `EMPTY_ID`,
    which sorts after every real id, so `ids` is sorted and a lower-bound
    search finds any member.
    """

    ids: torch.Tensor  # (D,) int32 ascending, EMPTY_ID = free slot
    values: torch.Tensor  # (D, d) int8
    scales: torch.Tensor  # (D, 1) f32
    sigs: torch.Tensor  # (D, words) int32 (uint32 bits)
    capacity: int = 0


def _delta_from_numpy(ids, values, scales, sigs, device) -> DeltaShard:
    return DeltaShard(
        ids=torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(device),
        values=torch.from_numpy(np.ascontiguousarray(values)).to(device),
        scales=torch.from_numpy(np.ascontiguousarray(scales)).to(device),
        sigs=torch.from_numpy(np.ascontiguousarray(sigs).view(np.int32)
                              ).to(device),
        capacity=int(len(ids)))


def empty_delta(capacity: int, embed_dim: int, words: int,
                device=None) -> DeltaShard:
    """An all-free delta shard of `capacity` slots on `device`."""
    capacity = int(capacity)
    return _delta_from_numpy(
        np.full((capacity,), EMPTY_ID, np.int32),
        np.zeros((capacity, embed_dim), np.int8),
        np.zeros((capacity, 1), np.float32),
        np.zeros((capacity, words), np.int32), device)


def delta_n_live(delta: DeltaShard) -> int:
    """Host-side count of occupied delta slots."""
    return int((delta.ids != EMPTY_ID).sum())


def _delta_numpy(delta: DeltaShard):
    """(ids, values, scales, sigs) of a delta shard as host arrays."""
    return (delta.ids.cpu().numpy(), delta.values.cpu().numpy(),
            delta.scales.cpu().numpy(), delta.sigs.cpu().numpy())


# ---------------------------------------------------------------------------
# plain delta-aware row resolution (the pool kernel's side table does this
# on the serve path; `kernels/ref.py:pool_slots` is its plain version)
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# the rows a rank holds
# ---------------------------------------------------------------------------
def _bank_span(engine) -> tuple[int, int]:
    """(first global row, row count) of the signature rows this rank
    holds: all of them unless the engine is bank-sharded."""
    rows = engine.item_sigs.shape[0]
    if engine.nns_axis is None:
        return 0, rows
    return engine.nns_mesh.get_local_rank(engine.nns_axis) * rows, rows


def global_rows(engine, x: torch.Tensor) -> torch.Tensor:
    """`x`, one of the engine's per-row tensors (signatures or mask), over
    every row: on a bank-sharded engine the banks all-gathered over the
    bank axis, in bank order (the padded layout); else `x` itself."""
    if engine.nns_axis is None:
        return x
    return torch.cat(all_gather_axis(x, engine.nns_mesh, engine.nns_axis))


# ---------------------------------------------------------------------------
# host-side epoch transitions (apply / compact / materialize / rebuild)
# ---------------------------------------------------------------------------
def ensure_live(engine, delta_capacity: int = 1024):
    """`engine` with an empty delta shard and an all-alive mask, if it has
    none (and a block summary, if it was built without one). A bank's pad
    rows are dead."""
    if engine.delta is not None:
        return engine
    n, d = engine.item_table_q.values.shape
    words = engine.item_sigs.shape[1]
    lo, rows = _bank_span(engine)
    n_valid = min(max(n - lo, 0), rows)
    summary = engine.block_summary
    if summary is None:
        summary = build_block_summary(engine.item_sigs, n_valid=n_valid)
    return dataclasses.replace(
        engine,
        delta=empty_delta(delta_capacity, d, words, engine.device),
        block_summary=summary,
        item_mask=torch.arange(rows, device=engine.device) < n_valid)


def quantize_updates(engine, rows):
    """f32 rows (m, d) -> host (int8 values, scales, int32 sigs): the
    build-time transform (`RecSysEngine.build`), applied per row."""
    if isinstance(rows, torch.Tensor):
        x = rows.to(engine.device, torch.float32)
    else:
        x = torch.from_numpy(np.asarray(rows, np.float32)).to(engine.device)
    q = quantize_rowwise(x)
    sigs = lsh_signature(dequantize_rowwise(q), engine.lsh_proj)
    return (q.values.cpu().numpy(), q.scales.cpu().numpy(),
            sigs.cpu().numpy())


def fold_updates(delta_np, n_base: int, mask, quantize, upsert_ids=None,
                 upsert_rows=None, delete_ids=None):
    """The update rule shared with the tiered catalog, on host arrays.

    delta_np: (ids, values, scales, sigs) of the current shard; mask: the
    (n_base,) alive array, updated in place; quantize: rows ->
    (values, scales, sigs). Deletes drop an id from the delta and
    tombstone its base row; upserts (re)place it in the delta and
    tombstone its base row; later entries win. -> (new delta arrays,
    touched ids). Raises `DeltaFullError` when the surviving set does not
    fit the shard.
    """
    ids_np, vals_np, scales_np, sigs_np = delta_np
    capacity = len(ids_np)
    live: dict[int, tuple] = {}
    for slot in np.nonzero(ids_np != EMPTY_ID)[0]:
        live[int(ids_np[slot])] = (vals_np[slot], scales_np[slot],
                                   sigs_np[slot])
    touched: list[int] = []
    if delete_ids is not None:
        for gid in np.asarray(delete_ids, np.int64).reshape(-1):
            gid = int(gid)
            live.pop(gid, None)
            if gid < n_base:
                mask[gid] = False
            touched.append(gid)
    if upsert_ids is not None:
        ids_arr = np.asarray(upsert_ids, np.int64).reshape(-1)
        if np.any(ids_arr < 0) or np.any(ids_arr >= EMPTY_ID):
            raise ValueError(f"item ids must be in [0, {EMPTY_ID})")
        uvals, uscales, usigs = quantize(upsert_rows)
        if len(ids_arr) != len(uvals):
            raise ValueError(f"{len(ids_arr)} ids vs {len(uvals)} rows")
        for i, gid in enumerate(ids_arr):
            gid = int(gid)
            live[gid] = (uvals[i], uscales[i], usigs[i])
            if gid < n_base:
                mask[gid] = False  # the delta row is the truth now
            touched.append(gid)
    if len(live) > capacity:
        raise DeltaFullError(
            f"{len(live)} pending rows > delta capacity {capacity}")
    ids_out = np.full(capacity, EMPTY_ID, np.int32)
    vals_out = np.zeros_like(vals_np)
    scales_out = np.zeros_like(scales_np)
    sigs_out = np.zeros_like(sigs_np)
    for slot, gid in enumerate(sorted(live)):  # ascending-id prefix
        v, s, g = live[gid]
        ids_out[slot], vals_out[slot] = gid, v
        scales_out[slot], sigs_out[slot] = s, g
    return (ids_out, vals_out, scales_out, sigs_out), touched


def engine_apply_updates(engine, upsert_ids=None, upsert_rows=None,
                         delete_ids=None):
    """Fold one update batch into the engine's delta shard (host-side).

    upsert_ids / upsert_rows: (m,) ids and (m, d) f32 rows — new ids
    extend the catalog, existing ids re-embed (the base row is tombstoned
    and the row rides the delta until the next compaction); delete_ids:
    ids to retire. Later entries win within a batch. Touched base blocks
    of the summary are recomputed exactly, and touched ids leave the hot
    cache. Raises `DeltaFullError` when the pending set does not fit.
    Returns a new engine; the old one stays valid.
    """
    if engine.delta is None:
        raise ValueError("engine has no delta shard; wrap it in "
                         "LiveCatalog or call ensure_live() first")
    n_base = int(engine.item_table_q.values.shape[0])
    mask = global_rows(engine, engine.item_mask).cpu().numpy().copy()
    new_np, touched = fold_updates(
        _delta_numpy(engine.delta), n_base, mask,
        lambda rows: quantize_updates(engine, rows), upsert_ids,
        upsert_rows, delete_ids)
    # this rank's rows of the new mask, and its own summary blocks
    lo, rows = _bank_span(engine)
    mask = mask[lo:lo + rows]
    summary = engine.block_summary
    base_touched = [g - lo for g in touched
                    if g < n_base and lo <= g < lo + rows]
    if summary is not None and base_touched:
        summary = update_block_summary(summary, engine.item_sigs, mask,
                                       base_touched)
    dev = engine.device
    return dataclasses.replace(
        engine, delta=_delta_from_numpy(*new_np, dev),
        item_mask=torch.from_numpy(mask.copy()).to(dev),
        block_summary=summary,
        item_hot=invalidate_rows(engine.item_hot, np.asarray(touched)))


def engine_refresh_model(engine, params):
    """A new engine serving new model parameters: the MLPs and the genre
    table swap in, the user-feature tables re-quantize, and every pinned
    user-feature hot row is re-pinned from its new table. Item rows are
    untouched (they go through `upsert`)."""
    tables_q = {k: quantize_rowwise(v) for k, v in params["tables"].items()}
    uiet_hot = {}
    for name, cache in engine.uiet_hot.items():
        if cache is not None and cache.capacity:
            ids = cache.hot_ids.cpu().numpy()
            uiet_hot[name] = pin_rows(tables_q[name], ids[ids != EMPTY_ID],
                                      cache.capacity)
        else:
            uiet_hot[name] = cache
    return dataclasses.replace(
        engine, params=params, tables_q=tables_q,
        genre_table_q=quantize_rowwise(params["genre_table"]),
        uiet_hot=uiet_hot)


def _zero_row(engine, d: int):
    """The canonical zero row: its quantization and its signature."""
    zero_q = quantize_rowwise(torch.zeros((1, d), dtype=torch.float32,
                                          device=engine.device))
    return zero_q, lsh_signature(dequantize_rowwise(zero_q), engine.lsh_proj)


def materialize(engine):
    """Fold base + delta into one flat table (the "final table"), on the
    engine's device.

    -> (QuantizedTensor (n_total, d), sigs (n_total, words), alive
    (n_total,) bool): n_total covers every id ever upserted. Untouched
    rows keep their base bytes, delta rows scatter in, and id gaps get the
    canonical zero row and stay dead. Both the compaction and the
    reference rebuild use it, so they fold the same table. A bank-sharded
    engine's signatures and mask are gathered from every bank.
    """
    n_base, d = engine.item_table_q.values.shape
    words = engine.item_sigs.shape[1]
    base_sigs = global_rows(engine, engine.item_sigs)
    base_mask = (None if engine.item_mask is None
                 else global_rows(engine, engine.item_mask))
    dev = engine.device
    gids = torch.zeros((0,), dtype=torch.long, device=dev)
    live = gids
    if engine.delta is not None:
        live = torch.nonzero(engine.delta.ids != EMPTY_ID).flatten()
        gids = engine.delta.ids[live].long()
    n_total = int(max(n_base, int(gids.max()) + 1 if len(gids) else 0))
    zero_q, zero_sig = _zero_row(engine, d)
    values = zero_q.values.expand(n_total, d).clone()
    scales = zero_q.scales.expand(n_total, 1).clone()
    sigs = zero_sig.expand(n_total, words).clone()
    values[:n_base] = engine.item_table_q.values
    scales[:n_base] = engine.item_table_q.scales
    sigs[:n_base] = base_sigs[:n_base]
    alive = torch.zeros((n_total,), dtype=torch.bool, device=dev)
    alive[:n_base] = True if base_mask is None else base_mask[:n_base]
    if len(gids):
        values[gids] = engine.delta.values[live]
        scales[gids] = engine.delta.scales[live]
        sigs[gids] = engine.delta.sigs[live]
        alive[gids] = True
    return QuantizedTensor(values=values, scales=scales), sigs, alive


def _summary_rows(engine) -> int:
    return (engine.block_summary.block_rows
            if engine.block_summary is not None else SUMMARY_BLOCK_ROWS)


def compact_engine(engine):
    """Fold the delta into a fresh base epoch -> the new engine: the
    materialized table, its alive mask, a summary built cold over them and
    an empty delta. The hot cache carries over (touched rows were evicted
    at update time, and surviving rows keep their bytes). A sharded engine
    is re-sharded onto its mesh after the fold."""
    if engine.delta is None:
        raise ValueError("engine has no delta shard to compact")
    table, sigs, alive = materialize(engine)
    d, words = table.values.shape[1], sigs.shape[1]
    out = dataclasses.replace(
        engine, item_table_q=table, item_sigs=sigs, item_mask=alive,
        block_summary=build_block_summary(sigs, _summary_rows(engine),
                                          db_mask=alive),
        delta=empty_delta(engine.delta.capacity, d, words, engine.device),
        nns_mesh=None, nns_axis=None, nns_query_axis=None)
    if engine.nns_mesh is not None:
        out = out.shard(engine.nns_mesh, engine.nns_axis,
                        query_axis=engine.nns_query_axis)
    return out


def unshard(engine):
    """`engine` in its unsharded layout (a collective on a mesh engine:
    every rank joins): a bank-sharded engine's signatures and mask
    gathered in bank order with the pad rows dropped, and a block summary
    built cold over them at the banks' block rows. Nothing is compacted:
    the base, the delta shard, the tombstones and the hot caches stay as
    they stand. An unsharded engine comes back as it is."""
    if engine.nns_mesh is None:
        return engine
    n = int(engine.item_table_q.values.shape[0])
    sigs = global_rows(engine, engine.item_sigs)[:n]
    mask = (None if engine.item_mask is None
            else global_rows(engine, engine.item_mask)[:n])
    return dataclasses.replace(
        engine, item_sigs=sigs, item_mask=mask,
        block_summary=build_block_summary(sigs, _summary_rows(engine),
                                          db_mask=mask),
        nns_mesh=None, nns_axis=None, nns_query_axis=None)


def rebuild_reference(engine):
    """A from-scratch engine over the live engine's final table: the
    bit-match oracle. Base, signatures and mask come from `materialize`,
    the summary is built cold, the delta is empty (of the same capacity),
    and the hot cache pins exactly the live cache's surviving hot set.
    Always unsharded."""
    table, sigs, alive = materialize(engine)
    d, words = table.values.shape[1], sigs.shape[1]
    cap = engine.item_hot.capacity
    item_hot = engine.item_hot
    if cap:
        hot = engine.item_hot.hot_ids.cpu().numpy()
        item_hot = pin_rows(table, hot[hot != EMPTY_ID], cap)
    capacity = engine.delta.capacity if engine.delta is not None else 0
    return dataclasses.replace(
        engine, item_table_q=table, item_sigs=sigs, item_mask=alive,
        block_summary=build_block_summary(sigs, _summary_rows(engine),
                                          db_mask=alive),
        item_hot=item_hot,
        delta=empty_delta(capacity, d, words, engine.device),
        nns_mesh=None, nns_axis=None, nns_query_axis=None)


def repin_hot_from_freqs(engine, freqs):
    """Refill the item hot cache with the `capacity` most looked-up alive
    base rows (`top_ids_by_freq`: frequency descending, ties by ascending
    id). Pending delta ids are never pinned (delta and hot stay disjoint).
    Results do not change; only the hit counters move."""
    cache = engine.item_hot
    if cache is None or not cache.capacity:
        return engine
    n = int(engine.item_table_q.values.shape[0])
    f = np.zeros((n,), np.int64)
    m = min(len(freqs), n)
    f[:m] = np.asarray(freqs)[:m]
    alive = (np.ones((n,), bool) if engine.item_mask is None
             else global_rows(engine, engine.item_mask)[:n].cpu().numpy()
             .copy())
    if engine.delta is not None:
        dids = engine.delta.ids.cpu().numpy()
        dids = dids[dids != EMPTY_ID]
        alive[dids[dids < n]] = False
    ids = top_ids_by_freq(f, cache.capacity, eligible=alive)
    return dataclasses.replace(
        engine, item_hot=pin_rows(engine.item_table_q, ids, cache.capacity))


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------
class LiveCatalog:
    """Versioned item catalog over a serving engine.

    Bounded delta ingestion (`upsert` / `delete`), epoch compaction
    (`compact`, forced when the delta fills unless `auto_compact=False`),
    publication of every new engine to attached front-ends (`attach`:
    buckets already dispatched finish on the engine they were dispatched
    against), and epoch-numbered snapshot / restore through the
    checkpointer. `.engine` is always safe to serve.
    """

    def __init__(self, engine, *, delta_capacity: int = 1024,
                 auto_compact: bool = True, registry=None):
        self.engine = ensure_live(engine, delta_capacity)
        self.epoch = 0
        self.auto_compact = auto_compact
        self.n_upserts = 0
        self.n_deletes = 0
        self.n_compactions = 0
        self.last_compact_s = 0.0
        self._servers: list = []
        # measured per-row lookup frequencies, grown past the base size as
        # new ids are upserted
        self.item_freqs = np.zeros(
            (int(self.engine.item_table_q.values.shape[0]),), np.int64)
        self.n_observed = 0
        # telemetry sink (obs.MetricsRegistry); without one, `attach`
        # adopts the first attached server's
        self.registry = None
        if registry is not None:
            self._set_registry(registry)

    def _set_registry(self, registry) -> None:
        if self.registry is None and registry is not None:
            self.registry = registry
            registry.register_collector(self._collect)

    def _collect(self, reg) -> None:
        """Snapshot-time collector: the lifecycle counters and the delta's
        occupancy, as `catalog.*` gauges."""
        reg.gauge("catalog.epoch", self.epoch)
        reg.gauge("catalog.upserts", self.n_upserts)
        reg.gauge("catalog.deletes", self.n_deletes)
        reg.gauge("catalog.compactions", self.n_compactions)
        reg.gauge("catalog.delta_pending", self.n_pending)
        reg.gauge("catalog.delta_capacity", self.delta_capacity)
        reg.gauge("catalog.observed_lookups", self.n_observed)
        reg.gauge("catalog.last_compact_s", self.last_compact_s)

    # -- publication ---------------------------------------------------
    def attach(self, server) -> None:
        """Publish every later engine to `server` (any front-end of
        `make_server`), feed this catalog's lookup frequencies from its
        `observer` hook, and adopt its registry if this catalog has none."""
        self._servers.append(server)
        if hasattr(server, "observer"):
            server.observer = self.observe
        self._set_registry(getattr(server, "registry", None))
        server.swap_engine(self.engine)

    def observe(self, ids) -> None:
        """Count served item lookups (negative and sentinel ids are
        ignored). Host-side only; results never depend on it."""
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

    @contextlib.contextmanager
    def _window(self):
        """Every attached front-end's pause window (a no-op for those
        without one), entered in attach order on every rank."""
        with contextlib.ExitStack() as stack:
            for server in self._servers:
                paused = getattr(server, "paused", None)
                if paused is not None:
                    stack.enter_context(paused())
            yield

    def _publish(self) -> None:
        if self.registry is not None:
            self.registry.event("publish", epoch=self.epoch,
                                delta_pending=self.n_pending)
        for server in self._servers:
            server.swap_engine(self.engine)

    # -- mutation ------------------------------------------------------
    def apply_updates(self, upsert_ids=None, upsert_rows=None,
                      delete_ids=None) -> None:
        """Apply one update batch; a full delta forces a compaction first
        (with `auto_compact=False` the `DeltaFullError` propagates)."""
        with self._window():
            self._apply_updates(upsert_ids, upsert_rows, delete_ids)

    def _apply_updates(self, upsert_ids, upsert_rows, delete_ids) -> None:
        try:
            engine = engine_apply_updates(self.engine, upsert_ids,
                                          upsert_rows, delete_ids)
        except DeltaFullError:
            if not self.auto_compact:
                raise
            self.compact()
            engine = engine_apply_updates(self.engine, upsert_ids,
                                          upsert_rows, delete_ids)
        self.engine = engine
        if upsert_ids is not None:
            self.n_upserts += len(np.asarray(upsert_ids).reshape(-1))
        if delete_ids is not None:
            self.n_deletes += len(np.asarray(delete_ids).reshape(-1))
        self._publish()

    def upsert(self, ids, rows) -> None:
        """Add or re-embed items: (m,) ids and (m, d) f32 rows."""
        self.apply_updates(upsert_ids=ids, upsert_rows=rows)

    def delete(self, ids) -> None:
        """Retire items: tombstoned out of retrieval at once."""
        self.apply_updates(delete_ids=ids)

    def refresh_model(self, params) -> None:
        """Publish new model parameters (`engine_refresh_model`)."""
        with self._window():
            self.engine = engine_refresh_model(self.engine, params)
            self._publish()

    def compact(self) -> float:
        """Fold the delta into a new base epoch and publish it; returns the
        pause in seconds (the fold runs synchronously; buckets queued on
        the old epoch keep their own tensors). Measured frequencies repin
        the hot cache."""
        with self._window():
            return self._compact()

    def _compact(self) -> float:
        t0 = time.perf_counter()
        engine = compact_engine(self.engine)
        if self.n_observed:
            engine = repin_hot_from_freqs(engine, self.item_freqs)
        _sync(engine)
        self.last_compact_s = time.perf_counter() - t0
        self.engine = engine
        self.epoch += 1
        self.n_compactions += 1
        if self.registry is not None:
            self.registry.observe("catalog.compact_pause_s",
                                  self.last_compact_s)
            self.registry.event("compact", epoch=self.epoch,
                                pause_s=self.last_compact_s,
                                n_items=self.n_items)
        self._publish()
        return self.last_compact_s

    # -- introspection -------------------------------------------------
    @property
    def n_pending(self) -> int:
        """Occupied delta slots awaiting compaction."""
        return delta_n_live(self.engine.delta)

    @property
    def delta_capacity(self) -> int:
        return self.engine.delta.capacity

    @property
    def n_items(self) -> int:
        """Alive catalog size: alive base rows plus live delta rows (the
        two id sets are disjoint: overwritten base rows are tombstoned)."""
        n_base = int(self.engine.item_table_q.values.shape[0])
        with self._window():
            alive = int(global_rows(self.engine,
                                    self.engine.item_mask)[:n_base].sum())
        return alive + delta_n_live(self.engine.delta)

    def rebuild_reference(self):
        """A from-scratch engine over the current final table (the
        bit-match oracle)."""
        return rebuild_reference(self.engine)

    # -- persistence ---------------------------------------------------
    def snapshot(self, directory) -> None:
        """Atomic epoch-numbered snapshot of the whole engine (base, delta,
        tombstones, hot caches, epoch) through the checkpointer, in the
        unsharded layout whatever the engine's (`unshard`; the module
        docstring names the leaf that differs). On a mesh engine every
        rank joins: rank 0 writes, and every rank returns once the epoch
        is committed."""
        from repro_torch.checkpoint import checkpointer

        with self._window():
            checkpointer.save(directory, self.epoch, unshard(self.engine),
                              collective=self.engine.nns_mesh is not None)

    def restore(self, directory) -> None:
        """Restore the latest committed snapshot onto the current engine's
        layout and publish it: the snapshot is read into the unsharded
        structure of the current engine (the template), its block summary
        is rebuilt cold at the template's block rows, and on a mesh engine
        it is re-sharded onto the template's mesh, bank axis and query
        axis. So a snapshot of any layout restores onto any other."""
        from repro_torch.checkpoint import checkpointer

        step = checkpointer.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed snapshot in {directory}")
        tmpl = self.engine
        with self._window():
            engine = checkpointer.restore(directory, step, dataclasses.replace(
                tmpl, block_summary=None, nns_mesh=None, nns_axis=None,
                nns_query_axis=None))
            engine = dataclasses.replace(
                engine, block_summary=build_block_summary(
                    engine.item_sigs, _summary_rows(tmpl),
                    db_mask=engine.item_mask))
            if tmpl.nns_mesh is not None:
                engine = engine.shard(tmpl.nns_mesh, tmpl.nns_axis,
                                      query_axis=tmpl.nns_query_axis)
            self.engine = engine
            self.epoch = step
            self._publish()
