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

**A mesh engine** (`RecSysEngine.shard`, any number of ranks, one
included) is served by every rank of its mesh, each making the same
`serve` calls, and so the same collectives, in the same order. The drain
thread forms its chunks by timing, which no two ranks share, so rank 0
alone forms them and the other ranks follow:

  * every rank calls ``make_server(engine, "concurrent", ...)`` with the
    same knobs at the same place of its program (construction broadcasts
    a token from rank 0 that names the stream). The mesh must span the
    process group's world;
  * rank 0 is the front door: tenant queues, admission, shedding,
    tickets, the trace and the drain thread. `submit` on any other rank
    raises `ServerConfigError`;
  * each drain chunk (the admitted queries, after shedding) is stacked
    and validated on rank 0 into one int32 row a query, the user features
    in the schema's order, then the genre and the history. A chunk that
    fails there resolves as ``status="error"`` and is never sent. Else
    rank 0 sends a fixed header (op, query count, sequence number,
    epoch) and broadcasts the rows on the mesh's device type (CPU tensors
    over gloo, CUDA tensors over NCCL);
  * the other ranks run a follow thread that takes rank 0's ops in
    sequence order and submits each chunk, unstacked, to an inner ring
    with the same ``max_batch``, ``buckets``, ``depth`` and ``coalesce``:
    the ring forms buckets deterministically from the submitted
    sequence, so every rank serves the same buckets. Every rank records
    each chunk's (sequence, epoch, count) in `chunk_log`, and every
    follower's inner counters equal rank 0's;
  * ``close()`` on rank 0 sends a close op once the drain is done;
    ``close()`` on a follower waits for it and joins the follow thread.

Where the stream can go wrong, and what it does about it:

  * **one collective order on every rank.** A bank-sharded
    `LiveCatalog` runs collectives from the caller's thread (its update
    mask, compaction, repinning, `n_items`, snapshots), and
    `OnlineTrainer.fold` from the training thread. Were they to
    interleave with the drain or follow thread's serve collectives in
    another order on another rank, gloo would pair the wrong messages or
    hang. So every engine swap and every catalog call runs inside a
    **pause window** (`paused()`): rank 0 takes the serve lock between
    chunks and sends a pause op; a follower's `paused()` waits until its
    follow thread has taken that op, and the follow thread then waits on
    a local event, outside any collective, until the window closes.
    Inside the window only the callers' threads run collectives, in the
    program's order on every rank; the first chunk after it serves the
    new epoch on every rank (a follower checks the header's epoch). The
    window is reentrant (`LiveCatalog._publish` swaps inside the
    catalog's own window), and `swap_engine` opens one itself;
  * **idle followers.** A follower waits for the next header on the
    process group's store (`c10d`'s default store), never inside a
    collective, so no traffic for longer than the group's timeout (or
    NCCL's watchdog) leaves it alive;
  * **errors during a chunk.** Once a chunk is sent the ranks cannot
    recover alone. A rank that fails writes which rank and why to the
    store (the first report stays) and ends its stream; every other rank
    fails in turn, at its next collective (within the group's timeout)
    or, waiting for a header, at its next look at the store, and the
    front-end on every rank closes. On rank 0 the failing chunk and every
    queued ticket resolve as ``status="error"``, ``last_error`` names
    the rank, and `submit` raises `ServerClosedError` naming it; a
    follower's ``close()`` raises `ServingError` naming it;
  * **devices and threads.** The drain and follow threads run under
    `torch.cuda.device(engine.device)`, so the broadcasts from them use
    CUDA tensors on the engine's card.

The store holds one 32-byte header an op until the process group ends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import secrets
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.nns import EMPTY_ID
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


# the ops of a mesh engine's stream (the header's first field)
OP_CHUNK, OP_PAUSE, OP_CLOSE = 1, 2, 3
# a follower's wait for the next header between looks at the store's
# failure key (a store wait, not a collective: no group timeout applies)
_POLL = datetime.timedelta(seconds=1)
_FAILED = "failed"


class _Stream:
    """Rank 0's ops to the other ranks of a mesh engine's front-end: a
    header an op on the process group's store, and a chunk's rows in one
    broadcast over the world group. Construction is a collective."""

    def __init__(self, engine: RecSysEngine):
        ranks = sorted(int(r) for r in engine.nns_mesh.mesh.flatten())
        if ranks != list(range(dist.get_world_size())):
            raise ServerConfigError(
                f"the concurrent front-end streams over the whole process "
                f"group; the engine's mesh holds ranks {ranks} of "
                f"{dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.device = engine.device
        self.names = (*sorted(engine.cfg.user_features), "genre")
        self.history_len = int(engine.cfg.history_len)
        token = torch.tensor([secrets.randbits(62) if self.rank == 0 else 0],
                             dtype=torch.int64, device=self.device)
        with _on_device(self.device):
            dist.broadcast(token, src=0)
        self.store = dist.PrefixStore(
            f"repro_torch/stream/{int(token.item())}/",
            dist.distributed_c10d._get_default_store())
        self.seq = 0

    # -- rank 0 --------------------------------------------------------
    def pack(self, queries: list[dict], engine: RecSysEngine) -> np.ndarray:
        """The chunk as (n, fields + history) int32 rows in schema order.
        Raises `ValueError` for a query the engine cannot serve: a missing
        field, a non-integer value, a history of another length, or an id
        outside its table (history ids may name items past the base while
        the engine has a delta shard)."""
        try:
            fields = np.array([[q[n] for n in self.names] for q in queries])
            hists = [np.asarray(q["history"]) for q in queries]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed query: {type(e).__name__}: {e}") \
                from None
        n = len(queries)
        if any(h.shape != (self.history_len,) for h in hists):
            raise ValueError(f"history must hold {self.history_len} ids a "
                             f"query, got shapes "
                             f"{sorted({h.shape for h in hists})}")
        hist = np.stack(hists)
        if fields.shape != (n, len(self.names)):
            raise ValueError(f"one scalar a field, got {fields.shape[1:]}")
        if fields.dtype.kind not in "iu" or hist.dtype.kind not in "iu":
            raise ValueError(f"query values must be integers, got "
                             f"{fields.dtype} fields and {hist.dtype} "
                             f"history")
        limits = np.array([engine.tables_q[k].values.shape[0]
                           for k in self.names[:-1]]
                          + [engine.genre_table_q.values.shape[0]])
        n_items = (EMPTY_ID if engine.delta is not None
                   else engine.item_table_q.values.shape[0])
        bad = [k for j, k in enumerate(self.names)
               if np.any((fields[:, j] < -1) | (fields[:, j] >= limits[j]))]
        if np.any((hist < -1) | (hist >= n_items)):
            bad.append("history")
        if bad:
            raise ValueError(f"ids outside their tables in {bad}")
        return np.concatenate([fields, hist], axis=1).astype(np.int32)

    def send(self, op: int, epoch: int, rows: np.ndarray | None = None
             ) -> int:
        """Send op `op` (with a chunk's rows) -> its sequence number."""
        seq = self.seq
        header = np.array([op, 0 if rows is None else len(rows), seq, epoch],
                          np.int64)
        self.store.set(str(seq), header.tobytes())
        self.seq += 1
        if rows is not None:
            dist.broadcast(torch.from_numpy(rows).to(self.device), src=0)
        return seq

    # -- the other ranks -----------------------------------------------
    def recv(self) -> tuple[int, int, int, int]:
        """The next (op, count, sequence, epoch), waiting on the store."""
        key = str(self.seq)
        while True:
            try:
                self.store.wait([key], _POLL)
                break
            except RuntimeError as e:
                if "timeout" not in str(e).lower():
                    raise
                failed = self.failed()
                if failed is not None:
                    raise ServingError(f"the stream failed on {failed}") \
                        from None
        op, count, seq, epoch = (int(x) for x in np.frombuffer(
            self.store.get(key), np.int64))
        self.seq += 1
        return op, count, seq, epoch

    def recv_rows(self, count: int) -> np.ndarray:
        rows = torch.empty((count, len(self.names) + self.history_len),
                           dtype=torch.int32, device=self.device)
        dist.broadcast(rows, src=0)
        return rows.cpu().numpy()

    def unpack(self, rows: np.ndarray) -> list[dict]:
        """Rows back into the `submit` schema (int32 scalars, history)."""
        f = len(self.names)
        return [{**{k: row[j] for j, k in enumerate(self.names)},
                 "history": row[f:]} for row in rows]

    # -- failures ------------------------------------------------------
    def failed(self) -> str | None:
        """Which rank failed and why, once one has reported."""
        if not self.store.check([_FAILED]):
            return None
        return self.store.get(_FAILED).decode()

    def report(self, what: str) -> None:
        """Record a failure for the other ranks (the first one stays)."""
        with contextlib.suppress(Exception):
            if not self.store.check([_FAILED]):
                self.store.set(_FAILED, what.encode())


def _on_device(device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


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

    On a mesh engine rank 0 drains and the other ranks follow its stream
    (module docstring); `leader` says which this rank is, and a follower
    starts its follow thread at construction whatever `autostart` says.
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
        # inner server / engine swaps; reentrant: rank 0's pause window
        # holds it while the window's own swaps take it again
        self._serve_lock = threading.RLock()
        self._mesh = engine.nns_mesh
        self._stream = _Stream(engine) if self._mesh is not None else None
        self.leader = self._stream is None or self._stream.rank == 0
        self.epoch = 0  # engine swaps so far: the epoch a chunk is served on
        self.chunk_log: deque = deque(maxlen=TRACE_CAP)  # (seq, epoch, n)
        self._window_lock = threading.RLock()  # one pause window at a time
        self._window_depth = 0
        self._paused = threading.Event()  # a follower took a pause op
        self._resumed = threading.Event()  # ... and its window closed
        self._stream_done = False  # the close op was sent / taken
        self._failed: str | None = None  # which rank broke the stream
        self._close_raised = False
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
        self._thread = threading.Thread(
            target=self._drain_loop if self.leader else self._follow_loop,
            name="serving-drain" if self.leader else "serving-follow",
            daemon=True)
        if autostart or not self.leader:
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
        if not self.leader:
            raise ServerConfigError(
                f"rank {self._stream.rank} follows rank 0's stream of this "
                f"mesh engine: submit on rank 0")
        with self._cv:
            if self._failed is not None:
                raise ServerClosedError(
                    f"the stream failed on {self._failed}")
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
        `submit()` raises `ServerClosedError` once close() begins. On a
        mesh engine rank 0 then sends the close op, and a follower waits
        for it; a follower whose stream failed raises `ServingError`
        (once).
        """
        if not self.leader:
            self._thread.join()
            with self._serve_lock:
                self._inner.close()
            if self._failed is not None and not self._close_raised:
                self._close_raised = True
                raise ServingError(f"the stream failed on {self._failed}")
            return
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self.start()  # a never-started frontend still drains its queues
        self._thread.join(timeout=120)
        if self._thread.is_alive():  # pragma: no cover - defensive
            raise ServingError("drain thread failed to stop within 120s")
        with self._serve_lock:
            if self._stream is not None and not self._stream_done \
                    and self._failed is None:
                self._stream.send(OP_CLOSE, self.epoch)
                self._stream_done = True
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
        with _on_device(self._inner.engine.device):
            self._drain()

    def _drain(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._closed or self._n_queued() > 0)
                if self._closed and not self._n_queued():
                    return
            served, failed = None, None
            # collect under the serve lock: what queues while a swap or a
            # pause window holds it leaves as one chunk after it
            with self._serve_lock:
                with self._cv:
                    batch = self._collect_locked(self.drain_chunk)
                    if not batch:  # pragma: no cover - drained meanwhile
                        continue
                    self._n_inflight += len(batch)
                queries = [q for (_, _, q, _) in batch]
                try:
                    if self._stream is not None:  # refused before it is sent
                        rows = self._stream.pack(queries, self.engine)
                except Exception as e:
                    self._contain(e)
                else:
                    try:
                        if self._stream is not None:
                            queries = self._send_chunk(rows)
                        served = self._serve(queries)
                    except Exception as e:  # the thread must survive
                        if self._stream is None:
                            self._contain(e)  # typed or not: the tickets
                        else:  # the ranks may have parted: stop them all
                            failed = (self._stream.failed()
                                      or f"rank 0: {type(e).__name__}: {e}")
            if failed is not None:
                self._fail(failed, batch)
                return
            self._resolve_batch(batch, served)

    def _send_chunk(self, rows: np.ndarray) -> list[dict]:
        """Send one packed chunk down the stream (under the serve lock)
        -> its queries, unstacked as every follower unstacks them."""
        failed = self._stream.failed()
        if failed is not None:
            raise ServingError(f"the stream failed on {failed}")
        t0 = time.perf_counter()
        seq = self._stream.send(OP_CHUNK, self.epoch, rows)
        self.registry.observe("serving.stream_s", time.perf_counter() - t0)
        self.chunk_log.append((seq, self.epoch, len(rows)))
        return self._stream.unpack(rows)

    def _serve(self, queries: list[dict]) -> list[ServedQuery]:
        """One chunk through the inner ring (under the serve lock)."""
        tickets = [self._inner.submit(q) for q in queries]
        self._inner.flush()
        served = [self._inner.result(t) for t in tickets]
        # the outer ticket is the unit of tracing: its span chain absorbs
        # the inner stamps, so drop the inner ring's duplicate records
        self._inner.take_trace()
        return served

    def _resolve_batch(self, batch: list, served) -> None:
        """Resolve a collected batch: served, or every ticket an error."""
        done = time.perf_counter()
        with self._cv:
            for i, (ticket, tenant, _, t_sub) in enumerate(batch):
                if served is not None:
                    status = STATUS_OK
                    chain = self._chain(t_sub, done, served[i].stages)
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

    def _fail(self, failed: str, batch: list) -> None:
        """Rank 0 after a broken stream: record which rank failed (a
        follower waiting for a header stops on it), close, and resolve the
        failed batch and every queued ticket as errors."""
        self._stream.report(failed)
        with self._cv:
            self._failed = failed
            self._closed = True
            self._last_error = f"the stream failed on {failed}"
            queued = self._collect_locked(self._n_queued())
            self._n_inflight += len(queued)
        self._resolve_batch(batch + queued, None)

    def _follow_loop(self) -> None:
        """A follower: take rank 0's ops in order until the close op."""
        try:
            with _on_device(self._inner.engine.device):
                self._follow()
        except Exception as e:
            own = f"rank {self._stream.rank}: {type(e).__name__}: {e}"
            self._stream.report(own)  # the first failure reported stays
            self._failed = self._stream.failed() or own
        finally:
            self._stream_done = True
            self._paused.set()  # wake a `paused()` waiting on this stream

    def _follow(self) -> None:
        while True:
            op, count, seq, epoch = self._stream.recv()
            if op == OP_CHUNK:
                if epoch != self.epoch:
                    raise ServingError(f"chunk {seq} of epoch {epoch} "
                                       f"reached epoch {self.epoch}")
                queries = self._stream.unpack(self._stream.recv_rows(count))
                with self._serve_lock:
                    self._serve(queries)
                self.chunk_log.append((seq, epoch, count))
            elif op == OP_PAUSE:
                self._paused.set()
                self._resumed.wait()
                self._resumed.clear()
            else:  # OP_CLOSE
                return

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
        untouched. On a mesh engine the swap runs in a pause window on
        every rank (`paused`), and the engine must stay on the same mesh.
        """
        if getattr(engine, "nns_mesh", None) is not self._mesh:
            raise ServerConfigError(
                "swap_engine: the new engine is on another mesh than the "
                "front-end's; start a new front-end")
        with self.paused(), self._serve_lock:
            self._inner.swap_engine(engine)
            self.epoch += 1

    @contextlib.contextmanager
    def paused(self):
        """A pause window of a mesh engine's stream: inside it no chunk is
        served on any rank, so the caller's collectives (catalog calls,
        engine swaps) run in one order on every rank. Every rank enters
        it at the same place of its program; reentrant in one thread. On
        rank 0 it holds the serve lock and sends a pause op; on a follower
        it waits until the follow thread has taken that op. A no-op on an
        unsharded engine (its swap takes the serve lock alone) and once
        the stream has closed; raises `ServingError` once it has failed.
        """
        if self._stream is None:
            yield
            return
        with self._window_lock:
            if self._window_depth == 0:
                self._open_window()
            self._window_depth += 1
            try:
                yield
            finally:
                self._window_depth -= 1
                if self._window_depth == 0:
                    self._close_window()

    def _open_window(self) -> None:
        if self.leader:
            self._serve_lock.acquire()
            try:
                if self._failed is not None:
                    raise ServingError(f"the stream failed on "
                                       f"{self._failed}")
                if not self._stream_done:
                    self._stream.send(OP_PAUSE, self.epoch)
            except BaseException:
                self._serve_lock.release()
                raise
            return
        self._paused.wait()
        if self._failed is not None:
            raise ServingError(f"the stream failed on {self._failed}")
        if not self._stream_done:
            self._paused.clear()

    def _close_window(self) -> None:
        if self.leader:
            self._serve_lock.release()
        elif not self._stream_done:
            self._resumed.set()

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
