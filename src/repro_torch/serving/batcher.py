"""Micro-batching request queue in front of the iMARS serve step.

Ported from `repro/serving/batcher.py`. Each submitted query is one user
hitting the recommendation fabric (paper Fig. 3). The batcher accumulates
queries, pads them to a small set of bucket shapes (powers of two up to
`max_batch`), and feeds each bucket through the serve step's three stages:

    queue  ->  (1a/1b*) UIET/ItET lookups + pooling   (one grouped
                        embedding-pool launch through the hot caches)
           ->  (1b/1c)  filtering DNN -> user embedding u_i
           ->  (1d)     fixed-radius Hamming NNS over ItET LSH signatures
           ->  (2a-2d)  ranking DNN: CTR per candidate
           ->  (2e)     CTR-buffer threshold top-k -> final items

Padding rows carry *invalid* ids (-1 everywhere) and a False `valid` bit:
they read zero rows, never touch the hot-row cache counters, and are
dropped before results are handed back, so padding never changes a served
result or a measured hit rate.

Torch runs eagerly, so the buckets only bound the set of batch shapes; the
hot-cache accumulator (`CacheStats` on the engine's device) is reassigned
per bucket and read on the host only by `stats()` / `snapshot()`.

Host <-> device: a bucket is stacked in numpy and staged onto the engine's
device by `stage_batch` (pinned buffers, asynchronous copies on a CUDA
device); its items, scores and blocks-touched come back through
`HostCopy` (pinned buffers, asynchronous copies and one event). The
synchronous `flush` waits for each bucket at once; the pipelined
`AsyncServer` waits only when it retires a bucket off its ring.

Telemetry: with ``trace=True`` (the default) every ticket carries a
stage-span chain (submit -> admit -> bucket -> dispatch -> scan -> rank ->
resolve, `repro_torch.obs.tracing.STAGES`) on its `ServedQuery.stages` and
on the `TicketTrace` records `take_trace()` hands back; the per-server
`MetricsRegistry` accumulates ticket-latency and per-stage histograms plus
pruned-scan block counts, and `stats()` is a view over `snapshot()`
(`server.stats_view`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry, TicketTrace
from repro_torch.serving.hot_cache import CacheStats
from repro_torch.serving.recsys_engine import (
    RecSysEngine,
    lookup_step,
    n_summary_blocks,
    rank_stage_step,
    scan_step,
)
from repro_torch.serving.server import (
    STATUS_OK,
    SchemaMismatchError,
    ServerClosedError,
    ServerConfigError,
    stats_view,
)

# tickets traced beyond this are dropped (counted in `serving.trace_dropped`)
# rather than growing the trace list without bound between take_trace calls
TRACE_CAP = 100_000


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to max_batch (always includes max_batch)."""
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def stage_batch(host: dict, device: torch.device) -> dict:
    """A stacked host batch (numpy) as tensors on `device`.

    On a CUDA device each array is copied into a fresh pinned buffer and
    sent with a non-blocking copy on the current stream, so the host never
    waits for the device here. PyTorch's caching host allocator records the
    copy's stream event on the buffer and reuses it only after that event,
    so dropping the buffer at once cannot corrupt a queued copy.
    """
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in host.items()}


class HostCopy:
    """Device tensors on their way to the host.

    On CUDA: one pinned buffer per tensor, filled by a non-blocking copy
    queued on the current stream, and one event recorded after the copies;
    `numpy()` waits on that event (the only host sync of a bucket) and
    returns host arrays. On the CPU the tensors are already there.
    """

    def __init__(self, tensors: Sequence[torch.Tensor]):
        dev = tensors[0].device
        self._event = None
        if dev.type != "cuda":
            self._host = list(tensors)
            return
        self._host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            self._host.append(h)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(dev))

    def numpy(self) -> list[np.ndarray]:
        """Wait for the copies, then the host arrays (copied out of the
        pinned buffers, which go back to the allocator's cache)."""
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy().copy() for h in self._host]


def _scan_event(indices: torch.Tensor):
    """An event recorded on the current stream after the scan that made
    `indices`; None on the CPU, where the scan has already run."""
    if indices.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(indices.device))
    return event


@dataclasses.dataclass
class ServedQuery:
    """One redeemed ticket: the recommendation (or its admission outcome).

    ``status`` is ``"ok"`` for an engine-served result; the concurrent
    front-end resolves rejected/failed tickets as ``"shed"`` / ``"error"``
    with sentinel payloads (items all -1, scores all 0) instead of raising
    through `result()` — see serving/server.py.
    """

    items: np.ndarray  # (top_k,) int32 recommended item ids, -1 padded
    scores: np.ndarray  # (top_k,) float32 CTR scores
    status: str = STATUS_OK  # "ok" | "shed" | "error"
    tenant: int = 0  # submitting tenant (0 for single-tenant front-ends)
    stages: tuple = ()  # stage-span chain (obs.tracing.STAGES); () untraced

    @property
    def ok(self) -> bool:
        """True when the engine actually served this ticket."""
        return self.status == STATUS_OK


class MicroBatcher:
    """Synchronous micro-batching queue over a `RecSysEngine`.

    submit() enqueues single-user queries (dicts of scalars + the history
    vector); flush() drains the queue through bucket-shaped serve steps;
    result() hands back per-ticket recommendations. `serve_many` is the
    one-call convenience wrapper.
    """

    mode = "sync"

    def __init__(self, engine: RecSysEngine, *, max_batch: int = 256,
                 buckets: Sequence[int] | None = None, trace: bool = True,
                 registry: MetricsRegistry | None = None):
        self.engine = engine
        self.max_batch = max_batch
        self.buckets = tuple(sorted(buckets or default_buckets(max_batch)))
        if self.buckets[-1] != max_batch:
            raise ServerConfigError(
                f"largest bucket {self.buckets[-1]} must equal "
                f"max_batch={max_batch} (buckets={self.buckets})")
        self._feature_names = tuple(sorted(engine.cfg.user_features.keys()))
        self._pending: list[tuple[int, dict]] = []
        self._results: dict[int, ServedQuery] = {}
        self._next_ticket = 0
        self._closed = False
        # hot-cache hits/lookups across every batch, on the engine's device
        self._stats = CacheStats.zero(engine.device)
        # optional lookup-frequency hook: called per served chunk with one
        # flat int array of the item ids the batch looked up — history rows
        # and the served items. Pure host-side telemetry; never affects
        # serving results.
        self.observer = None
        self._tenant_of: dict[int, int] = {}  # ticket -> submitting tenant
        self._per_tenant: dict[int, dict] = {}
        self.n_served = 0
        self.n_padded = 0
        self.n_batches = 0
        # telemetry: stage spans per open ticket + completed-ticket trace
        self.trace = bool(trace)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.registry.register_collector(self._collect)
        self._spans: dict[int, list] = {}
        self._trace: list[TicketTrace] = []
        self.n_trace_dropped = 0

    # ------------------------------------------------------------------
    def swap_engine(self, engine: RecSysEngine) -> None:
        """Atomically swap to a new engine between buckets.

        Every bucket dispatched *after* the swap serves from `engine`;
        buckets already dispatched (the `AsyncServer` in-flight ring) hold
        the old engine's tensors and finish on it — a bucket is always
        entirely one engine. The hot-cache accumulator and the
        served/padded counters carry over.
        """
        if tuple(sorted(engine.cfg.user_features.keys())) \
                != self._feature_names:
            raise SchemaMismatchError(
                "swap_engine: user-feature schema changed; "
                "start a new server instead")
        self.engine = engine

    # ------------------------------------------------------------------
    def submit(self, query: dict, *, tenant: int = 0) -> int:
        """Enqueue one user query; returns a ticket for `result()`.

        `tenant` tags the ticket for per-tenant accounting (`stats()`);
        single-tenant front-ends serve every tenant from the one queue.
        """
        if self._closed:
            raise ServerClosedError("submit() on a closed server")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, query))
        if tenant != 0:
            self._tenant_of[ticket] = tenant
        t = self._per_tenant.setdefault(tenant, {"submitted": 0, "served": 0,
                                                 "shed": 0, "errors": 0})
        t["submitted"] += 1
        if self.trace:
            # the synchronous front-ends admit unconditionally: the admit
            # boundary coincides with submit (no queue to shed from)
            now = time.perf_counter()
            self._spans[ticket] = [("submit", now), ("admit", now)]
        return ticket

    def result(self, ticket: int, *,
               timeout: float | None = None) -> ServedQuery:
        """Recommendations for `ticket` (flushes the queue if still pending).

        Pops the result — each ticket can be redeemed exactly once.
        `timeout` is accepted for protocol uniformity; the synchronous
        front-ends resolve every ticket inside `flush()` and never wait.
        """
        if ticket not in self._results:
            self.flush()
        return self._results.pop(ticket)

    def serve_many(self, queries: Sequence[dict], *,
                   tenant: int = 0) -> list[ServedQuery]:
        """Submit, flush, and collect: one ServedQuery per input query,
        in submission order."""
        tickets = [self.submit(q, tenant=tenant) for q in queries]
        self.flush()
        return [self.result(t) for t in tickets]

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Drain the queue through bucket-shaped serve steps, one bucket
        at a time: each waits for its results before the next is stacked.
        When tracing, an event recorded between the scan and the rank
        stage (both queued first) stamps the scan -> rank boundary. Pruned
        scans feed their blocks-touched counts into the registry.
        """
        while self._pending:
            chunk = self._pending[: self.max_batch]
            self._pending = self._pending[self.max_batch:]
            bucket = next(b for b in self.buckets if b >= len(chunk))
            t_bucket = time.perf_counter() if self.trace else 0.0
            batch = self._stack([q for _, q in chunk], bucket)
            # serve_step, stage by stage
            u, pooled, stats = lookup_step(self.engine, batch, self._stats)
            nns = scan_step(self.engine, u)
            scanned = _scan_event(nns.indices) if self.trace else None
            items, top, self._stats = rank_stage_step(
                self.engine, batch, nns.indices, u, pooled, stats)
            if self.trace:
                t_dispatch = time.perf_counter()
                if scanned is not None:
                    scanned.synchronize()
                t_scan = time.perf_counter()
            items, scores = HostCopy([items, top.scores]).numpy()
            if self.trace:
                t_rank = time.perf_counter()
                self._meter_scan(nns)
                self.registry.observe("serving.stage.dispatch_s",
                                      t_dispatch - t_bucket)
                self.registry.observe("serving.stage.scan_s",
                                      t_scan - t_dispatch)
                self.registry.observe("serving.stage.rank_s",
                                      t_rank - t_scan)
                tail = (("bucket", t_bucket), ("dispatch", t_dispatch),
                        ("scan", t_scan), ("rank", t_rank))
                for ticket, _ in chunk:
                    self._spans.setdefault(ticket, []).extend(tail)
            self._observe(chunk, items)
            for row, (ticket, _) in enumerate(chunk):
                self._resolve(ticket, items[row], scores[row])
            self.n_served += len(chunk)
            self.n_padded += bucket - len(chunk)
            self.n_batches += 1

    def _observe(self, chunk, items) -> None:
        """Feed the frequency observer one served chunk's item lookups:
        the real (non-padding) queries' history ids plus the items served
        back to them. Invalid (-1) ids are filtered by the observer."""
        if self.observer is None or not len(chunk):
            return
        hist = np.concatenate(
            [np.asarray(q["history"], np.int64).reshape(-1)
             for _, q in chunk])
        served = np.asarray(items[: len(chunk)], np.int64).reshape(-1)
        self.observer(np.concatenate([hist, served]))

    def _resolve(self, ticket: int, items, scores) -> None:
        """Record one served ticket (+ its tenant accounting + spans)."""
        tenant = self._tenant_of.pop(ticket, 0)
        stages = self._close_span(ticket, tenant, STATUS_OK)
        self._results[ticket] = ServedQuery(items=items, scores=scores,
                                            tenant=tenant, stages=stages)
        self._per_tenant[tenant]["served"] += 1

    def _close_span(self, ticket: int, tenant: int, status: str) -> tuple:
        """Stamp the resolve boundary, record the `TicketTrace`, and feed
        the latency histograms; returns the finished span chain."""
        if not self.trace:
            return ()
        span = self._spans.pop(ticket, None)
        if not span:
            return ()
        t_res = time.perf_counter()
        span.append(("resolve", t_res))
        stages = tuple(span)
        t_sub = span[0][1]
        self._record_trace(
            TicketTrace(ticket, tenant, t_sub, t_res, status, stages))
        self.registry.observe("serving.ticket_latency_s", t_res - t_sub)
        return stages

    def _record_trace(self, rec: TicketTrace) -> None:
        if len(self._trace) >= TRACE_CAP:
            self.n_trace_dropped += 1
            return
        self._trace.append(rec)

    def take_trace(self) -> list[TicketTrace]:
        """Return and clear the completed-ticket trace (load harness);
        every record carries its span chain when the server was built
        with ``trace=True``."""
        out, self._trace = self._trace, []
        return out

    def _meter_scan(self, nns) -> None:
        """Accumulate pruned-scan effectiveness counters (blocks touched
        per query vs the catalog's summary blocks -> scan_frac). Called
        after the ranked items reached the host, so reading the tiny
        per-query counts waits for nothing still running."""
        bt = getattr(nns, "blocks_touched", None)
        if bt is not None:
            self._count_blocks(HostCopy([bt]).numpy()[0])

    def _count_blocks(self, bt: np.ndarray) -> None:
        self.registry.count("nns.blocks_touched", int(bt.sum()))
        self.registry.count("nns.block_scan_queries", int(bt.size))

    def _stack_np(self, queries: list[dict], bucket: int) -> dict:
        """Stack per-user queries into one padded (bucket, ...) host batch.

        Padding rows are INVALID queries: every id is -1, so they read zero
        rows and can never count as hot-cache lookups — even without the
        `valid` row mask (which still marks real queries so their results
        are the ones handed back). Returns numpy arrays so callers (the
        pipelined `AsyncServer`) can concatenate several buckets into one
        batch before the single device transfer.
        """
        n = len(queries)
        history_len = len(np.asarray(queries[0]["history"]))
        batch = {
            name: np.full(bucket, -1, np.int32) for name in
            (*self._feature_names, "genre")
        }
        batch["history"] = np.full((bucket, history_len), -1, np.int32)
        for name in (*self._feature_names, "genre"):
            batch[name][:n] = [q[name] for q in queries]
        batch["history"][:n] = np.stack(
            [np.asarray(q["history"], np.int32) for q in queries])
        batch["valid"] = np.arange(bucket) < n
        return batch

    def _stack(self, queries: list[dict], bucket: int) -> dict:
        """`_stack_np` staged on the engine's device (`stage_batch`)."""
        return stage_batch(self._stack_np(queries, bucket),
                           self.engine.device)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Flush everything pending, then stop admitting queries.

        Idempotent; `submit()` afterwards raises `ServerClosedError`.
        Unredeemed tickets stay redeemable through `result()`.
        """
        if not self._closed:
            self.flush()
            self._closed = True

    def _collect(self, reg: MetricsRegistry) -> None:
        """Snapshot-time collector: publish the plain-int serving counters
        as registry gauges/info. The hot-cache accumulator lives on the
        device; this is the one place it is read (a host sync)."""
        cache = self._stats.as_dict()
        reg.info("serving.mode", self.mode)
        reg.info("serving.closed", self._closed)
        reg.gauge("serving.submitted", self._next_ticket)
        reg.gauge("serving.served", self.n_served)
        reg.gauge("serving.shed", 0)
        reg.gauge("serving.errors", 0)
        reg.gauge("serving.pending", len(self._pending))
        reg.gauge("serving.padded", self.n_padded)
        reg.gauge("serving.batches", self.n_batches)
        reg.gauge("serving.trace_dropped", self.n_trace_dropped)
        reg.gauge("cache.hits", cache["hits"])
        reg.gauge("cache.lookups", cache["lookups"])
        reg.gauge("nns.summary_blocks", n_summary_blocks(self.engine))
        reg.info("serving.per_tenant",
                 {t: dict(v) for t, v in self._per_tenant.items()})

    def snapshot(self) -> dict:
        """The full telemetry snapshot (`MetricsRegistry.snapshot`):
        merged counters + collector gauges + histogram summaries."""
        return self.registry.snapshot()

    def stats(self) -> dict:
        """The unified `Server` stats schema — a view over `snapshot()`
        (`server.stats_view`)."""
        return stats_view(self.snapshot())
