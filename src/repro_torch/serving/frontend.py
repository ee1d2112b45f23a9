"""Concurrent multi-tenant serving tier: bounded queues + a drain thread.

Ported from `repro/serving/frontend.py`.

The `AsyncServer` ring overlaps host batching with device compute, but it
is still a *closed-loop* front-end: one caller, one unbounded queue, and a
flush that admits everything ever submitted. A datacenter-shaped serving
tier (the "scale-in" observation: RecSys deployments lose their
accelerator wins in the serving tier, not the kernels) needs the opposite
discipline under open-loop load:

  * **per-tenant bounded queues** — each tenant (product surface, shard,
    or customer) owns a FIFO of at most ``queue_depth`` waiting queries,
    so one tenant's burst cannot grow another tenant's latency without
    bound;
  * **admission control / load shedding** — a submit against a full
    tenant queue is rejected *immediately* with a ``status="shed"``
    ticket (accounted per tenant in `stats()`), trading goodput for a
    bounded p99 instead of collapsing into unbounded queueing latency;
  * **a single drain thread** — queries are collected round-robin across
    tenant queues into engine-shaped chunks and served through an inner
    `AsyncServer` ring. One thread issues every device call, so device
    work stays single-writer while submits stay lock-cheap and
    thread-safe. PyTorch's current device is per thread, so the drain
    loop runs under `torch.cuda.device(engine.device)` when the engine is
    on a GPU, and launches on that device's current stream;
  * **typed failure containment** — a `ServingError` raised while
    draining (e.g. a schema-mismatched epoch swap) resolves the affected
    tickets as ``status="error"`` and the thread keeps draining; nothing
    in the overload path can kill it.

Bit-for-bit contract (tests/test_torch_serving.py): the admitted stream
serves byte-identically to the synchronous `MicroBatcher` given the same
engine and the same buckets. Threading, interleaving, and shedding move
*time and admission*; they can change a query's result only where they
put it in a bucket of another size, and then by the last bit of its CTRs
(PyTorch's matmul may round a product of another row count differently,
e.g. a one-row bucket's; the reference's XLA CPU dot does not).

Open-loop measurement hooks: every ticket is timestamped at submit and at
resolve; `take_trace()` hands `repro_torch.obs.TicketTrace` records —
(ticket, tenant, submit_s, done_s, status, stages) — to the load harness
(`serving/load_gen.py`), which turns them into per-tenant p50/p99 latency
and shed accounting. With ``trace=True`` every record (including shed and
error tickets) carries a stage-span chain: the outer submit/admit stamps,
the inner ring's bucket/dispatch/scan/rank stamps, and the outer resolve
— so queue wait shows up as the admit -> bucket gap (docs/OBSERVABILITY.md).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry, TicketTrace
from repro_torch.serving.async_server import AsyncServer
from repro_torch.serving.batcher import TRACE_CAP, ServedQuery
from repro_torch.serving.recsys_engine import RecSysEngine
from repro_torch.serving.server import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED,
    QueueFullError,
    ServerClosedError,
    ServerConfigError,
    ServingError,
    stats_view,
)

# the stages of an inner span chain the outer ticket inherits (the inner
# submit/admit/resolve stamps are replaced by the outer ticket's own)
_INNER_STAGES = frozenset(("bucket", "dispatch", "scan", "rank"))


class ConcurrentFrontend:
    """Threaded multi-tenant front-end over an inner `AsyncServer` ring.

    Conforms to the unified `Server` protocol (serving/server.py);
    construct via ``make_server(engine, mode="concurrent", ...)``.

    Args:
      engine: the serving engine.
      tenants: tenant count; tenant ids are ``0..tenants-1``.
      queue_depth: max waiting queries per tenant queue; a submit beyond
        it is shed (``None`` = unbounded, never sheds).
      max_batch / buckets / depth / coalesce: inner `AsyncServer` knobs.
      drain_chunk: max queries the drain thread collects per cycle
        (default ``max_batch * depth * coalesce`` — enough to keep the
        ring full).
      shed: when False, a full queue raises `QueueFullError` at submit
        instead of resolving the ticket as shed (closed-loop callers).
      autostart: start the drain thread at construction (tests pass
        False to stage deterministic overloads, then call `start()`).
      trace / registry: stage-span tracing + the shared telemetry
        registry (repro_torch.obs); the inner ring shares the registry, so
        one `snapshot()` covers the whole front-end.
    """

    mode = "concurrent"

    def __init__(self, engine: RecSysEngine, *, tenants: int = 1,
                 queue_depth: int | None = 256, max_batch: int = 256,
                 buckets: Sequence[int] | None = None, depth: int = 2,
                 coalesce: int | None = None, drain_chunk: int | None = None,
                 shed: bool = True, autostart: bool = True,
                 trace: bool = True,
                 registry: MetricsRegistry | None = None):
        if tenants < 1:
            raise ServerConfigError(f"tenants must be >= 1, got {tenants}")
        if queue_depth is not None and queue_depth < 1:
            raise ServerConfigError(
                f"queue_depth must be >= 1 or None, got {queue_depth}")
        self.trace = bool(trace)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._inner = AsyncServer(engine, max_batch=max_batch,
                                  buckets=buckets, depth=depth,
                                  coalesce=coalesce, trace=trace,
                                  registry=self.registry)
        # registered after the inner collector, so the outer view of the
        # shared gauges (submitted/shed/errors/pending/per_tenant) wins
        self.registry.register_collector(self._collect)
        self.tenants = tuple(range(tenants))
        self.queue_depth = queue_depth
        self.shed = shed
        self.drain_chunk = (drain_chunk if drain_chunk is not None else
                            max_batch * depth * self._inner.coalesce)
        if self.drain_chunk < 1:
            raise ServerConfigError(
                f"drain_chunk must be >= 1, got {self.drain_chunk}")

        self._cv = threading.Condition()
        self._serve_lock = threading.Lock()  # inner server / engine swaps
        self._queues: dict[int, deque] = {t: deque() for t in self.tenants}
        self._per_tenant = {t: {"submitted": 0, "served": 0, "shed": 0,
                                "errors": 0} for t in self.tenants}
        self._results: dict[int, ServedQuery] = {}
        self._outstanding: set[int] = set()
        self._trace: list[TicketTrace] = []
        self.n_trace_dropped = 0
        self._next_ticket = 0
        self._n_inflight = 0  # collected from queues, not yet resolved
        self._rr = 0  # round-robin start tenant for the next collect
        self._closed = False
        self._started = False
        self._last_error: str | None = None
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="serving-drain", daemon=True)
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, query: dict, *, tenant: int = 0) -> int:
        """Admit (or shed) one query into `tenant`'s bounded queue.

        Thread-safe; never blocks on the drain thread. Returns a ticket —
        shed submissions get a ticket too, already resolved with
        ``status="shed"``, so accounting and redemption stay uniform.
        """
        with self._cv:
            if self._closed:
                raise ServerClosedError("submit() on a closed server")
            if tenant not in self._queues:
                raise ServerConfigError(
                    f"unknown tenant {tenant!r}; configured: {self.tenants}")
            ticket = self._next_ticket
            self._next_ticket += 1
            self._outstanding.add(ticket)
            self._per_tenant[tenant]["submitted"] += 1
            now = time.perf_counter()
            q = self._queues[tenant]
            if self.queue_depth is not None and len(q) >= self.queue_depth:
                if not self.shed:
                    self._outstanding.discard(ticket)
                    self._per_tenant[tenant]["submitted"] -= 1
                    raise QueueFullError(
                        f"tenant {tenant} queue at depth {len(q)}")
                self._per_tenant[tenant]["shed"] += 1
                stages = ((("submit", now), ("admit", now),
                           ("resolve", now)) if self.trace else ())
                self._results[ticket] = self._sentinel(
                    tenant, STATUS_SHED, stages)
                self._record_trace(TicketTrace(ticket, tenant, now, now,
                                               STATUS_SHED, stages))
                self._cv.notify_all()
                return ticket
            q.append((ticket, tenant, query, now))
            self._cv.notify_all()  # wake the drain thread
            return ticket

    def _sentinel(self, tenant: int, status: str,
                  stages: tuple = ()) -> ServedQuery:
        k = self._inner.engine.top_k
        return ServedQuery(items=np.full(k, -1, np.int32),
                           scores=np.zeros(k, np.float32),
                           status=status, tenant=tenant, stages=stages)

    def _record_trace(self, rec: TicketTrace) -> None:
        """Append under `_cv` (held by every caller); capped like the
        single-tenant front-ends so an unharvested trace can't grow
        without bound between `take_trace()` calls."""
        if len(self._trace) >= TRACE_CAP:
            self.n_trace_dropped += 1
            return
        self._trace.append(rec)

    # ------------------------------------------------------------------
    # redemption / draining
    # ------------------------------------------------------------------
    def result(self, ticket: int, *,
               timeout: float | None = None) -> ServedQuery:
        """Block until `ticket` resolves; pops it (redeem exactly once)."""
        with self._cv:
            if ticket not in self._outstanding:
                raise KeyError(f"ticket {ticket} unknown or already redeemed")
            if not self._cv.wait_for(lambda: ticket in self._results,
                                     timeout=timeout):
                raise TimeoutError(f"ticket {ticket} unresolved after "
                                   f"{timeout}s")
            self._outstanding.discard(ticket)
            return self._results.pop(ticket)

    def serve_many(self, queries: Sequence[dict], *,
                   tenant: int = 0) -> list[ServedQuery]:
        """Submit, flush, and collect, in submission order (shed tickets
        come back as ``status="shed"`` sentinels, not exceptions)."""
        tickets = [self.submit(q, tenant=tenant) for q in queries]
        self.flush()
        return [self.result(t) for t in tickets]

    def start(self) -> None:
        """Start the drain thread (no-op if already running)."""
        with self._cv:
            if self._started:
                return
            self._started = True
        self._thread.start()

    def flush(self) -> None:
        """Block until every admitted query has resolved its ticket."""
        self.start()
        with self._cv:
            self._cv.wait_for(
                lambda: self._n_queued() == 0 and self._n_inflight == 0)

    def close(self) -> None:
        """Drain everything admitted, then stop; idempotent, no deadlock.

        In-flight and queued tickets are resolved (served, not shed)
        before the drain thread exits; they stay redeemable afterwards.
        `submit()` raises `ServerClosedError` once close() begins.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self.start()  # a never-started frontend still drains its queues
        self._thread.join(timeout=120)
        if self._thread.is_alive():  # pragma: no cover - defensive
            raise ServingError("drain thread failed to stop within 120s")
        with self._serve_lock:
            self._inner.close()

    def _n_queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _collect_locked(self, limit: int) -> list:
        """Round-robin up to `limit` queued entries across tenant queues.

        Fair interleave: one query per non-empty tenant per cycle, so a
        backlogged tenant cannot starve the others between drains.
        """
        batch: list = []
        n = len(self.tenants)
        while len(batch) < limit:
            took = False
            for k in range(n):
                if len(batch) >= limit:
                    break
                q = self._queues[self.tenants[(self._rr + k) % n]]
                if q:
                    batch.append(q.popleft())
                    took = True
            if not took:
                break
        self._rr = (self._rr + 1) % n
        return batch

    def _drain_loop(self) -> None:
        dev = self._inner.engine.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            self._drain()

    def _drain(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._closed or self._n_queued() > 0)
                batch = self._collect_locked(self.drain_chunk)
                if not batch:
                    if self._closed:
                        return
                    continue  # pragma: no cover - spurious wakeup
                self._n_inflight += len(batch)
            served = None
            try:
                with self._serve_lock:
                    tickets = [self._inner.submit(q)
                               for (_, _, q, _) in batch]
                    self._inner.flush()
                    served = [self._inner.result(t) for t in tickets]
                    # the outer ticket is the unit of tracing: its span
                    # chain absorbs the inner stamps below, so drop the
                    # inner ring's duplicate trace records
                    self._inner.take_trace()
            except ServingError as e:
                self._contain(e)  # typed: surface through the tickets
            except Exception as e:  # defensive: the thread must survive
                self._contain(e)
            done = time.perf_counter()
            with self._cv:
                for i, (ticket, tenant, _, t_sub) in enumerate(batch):
                    if served is not None:
                        status = STATUS_OK
                        chain = self._chain(t_sub, done,
                                            served[i].stages)
                        self._results[ticket] = dataclasses.replace(
                            served[i], tenant=tenant, stages=chain)
                        self._per_tenant[tenant]["served"] += 1
                    else:
                        status = STATUS_ERROR
                        chain = self._chain(t_sub, done, ())
                        self._results[ticket] = self._sentinel(
                            tenant, STATUS_ERROR, chain)
                        self._per_tenant[tenant]["errors"] += 1
                    self._record_trace(TicketTrace(
                        ticket, tenant, t_sub, done, status, chain))
                    if self.trace:
                        self.registry.observe("serving.e2e_latency_s",
                                              done - t_sub)
                self._n_inflight -= len(batch)
                self._cv.notify_all()

    def _chain(self, t_sub: float, done: float, inner: tuple) -> tuple:
        """The outer ticket's span chain: outer submit/admit stamps, the
        inner ring's bucket/dispatch/scan/rank stamps (queue wait is the
        admit -> bucket gap), and the outer resolve. Error tickets carry
        the degenerate submit -> admit -> resolve chain."""
        if not self.trace:
            return ()
        mid = tuple((s, t) for s, t in inner if s in _INNER_STAGES)
        return (("submit", t_sub), ("admit", t_sub), *mid,
                ("resolve", done))

    def _contain(self, exc: Exception) -> None:
        """Reset the inner server after a drain failure (tickets resolve
        as ``status="error"``; the thread keeps serving later chunks).
        Dropped ring entries hold only their own buffers (fresh pinned
        copies, stream-ordered device tensors), which no later dispatch
        reuses while a copy is queued."""
        self._last_error = f"{type(exc).__name__}: {exc}"
        with self._serve_lock:
            self._inner._pending = []
            self._inner._ring.clear()
            self._inner._results.clear()
            spans = getattr(self._inner, "_spans", None)
            if spans is not None:  # tests inject span-less fake inners
                spans.clear()

    # ------------------------------------------------------------------
    # engine swaps / stats / trace
    # ------------------------------------------------------------------
    @property
    def engine(self):
        return self._inner.engine

    def swap_engine(self, engine: RecSysEngine) -> None:
        """Epoch swap between drain chunks (LiveCatalog publication point).

        Serializes against the drain thread: the swap lands between inner
        flushes, so a chunk is always entirely one epoch. A schema change
        raises `SchemaMismatchError` to the *caller*; the drain thread is
        untouched.
        """
        with self._serve_lock:
            self._inner.swap_engine(engine)

    def take_trace(self) -> list[TicketTrace]:
        """Return and clear the completed-ticket trace (load harness /
        `tools/obs_report.py`); one record per submitted ticket, each
        carrying its span chain when the server traces."""
        with self._cv:
            out, self._trace = self._trace, []
            return out

    def _collect(self, reg: MetricsRegistry) -> None:
        """Snapshot-time collector for the multi-tenant accounting; runs
        after the inner ring's collector on the shared registry, so the
        outer view of submitted/shed/errors/pending/per_tenant wins.
        `Condition` wraps an RLock, so taking `_cv` here is safe even
        when `snapshot()` is called under it."""
        with self._cv:
            per_tenant = {t: dict(v) for t, v in self._per_tenant.items()}
            reg.info("serving.mode", self.mode)
            reg.info("serving.closed", self._closed)
            reg.gauge("serving.submitted", self._next_ticket)
            reg.gauge("serving.shed",
                      sum(v["shed"] for v in per_tenant.values()))
            reg.gauge("serving.errors",
                      sum(v["errors"] for v in per_tenant.values()))
            reg.gauge("serving.pending",
                      self._n_queued() + self._n_inflight)
            reg.gauge("serving.trace_dropped", self.n_trace_dropped)
            reg.gauge("serving.drain_chunk", self.drain_chunk)
            reg.info("serving.per_tenant", per_tenant)
            reg.info("serving.queue_depth", self.queue_depth)
            reg.info("serving.queued_now",
                     {t: len(q) for t, q in self._queues.items()})
            reg.info("serving.last_error", self._last_error)

    def snapshot(self) -> dict:
        """The full telemetry snapshot: shared registry, so inner-ring
        counters/histograms and multi-tenant accounting in one dict."""
        return self.registry.snapshot()

    def stats(self) -> dict:
        """The unified `Server` stats schema + tenant/queue accounting —
        a compatibility view over `snapshot()` (`server.stats_view`)."""
        return stats_view(self.snapshot())
