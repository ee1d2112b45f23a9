"""One serving API for every front-end: the `Server` protocol + factory.

A copy of `repro/serving/server.py`; only the imports changed.

The serving tier grew three front-ends — the synchronous `MicroBatcher`,
the pipelined `AsyncServer` ring, and the threaded multi-tenant
`ConcurrentFrontend` — and three front-ends must not mean three divergent
submit/ticket/flush APIs. This module pins the one contract they all
implement and the one constructor call sites use:

    server = make_server(engine, mode="sync" | "pipelined" | "concurrent")
    ticket = server.submit(query, tenant=0)   # -> opaque int ticket
    served = server.result(ticket)            # ServedQuery(items, scores,
                                              #             status, tenant)
    server.flush()                            # drain everything submitted
    server.stats()                            # one dict schema, all modes
    server.close()                            # idempotent; submit() after
                                              # close raises ServerClosedError

Tickets are redeemed exactly once and `result()` never raises for an
overloaded request: admission failures come back as a ServedQuery whose
``status`` is ``"shed"`` (and drain-side typed failures as ``"error"``),
so a load-shedding path is an accounted outcome, not an exception that
kills a drain thread. Every *configuration* error, by contrast, is a typed
exception from the `ServingError` family below.

Bit-for-bit contract (tested in tests/test_torch_serving.py): for the
same engine and the same admitted query stream, every mode returns
identical items, scores, and hot-cache counters — front-ends move *time*
(batching, pipelining, threading), never results.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover - type-only import, avoids a cycle
    from repro_torch.serving.batcher import ServedQuery


# ---------------------------------------------------------------------------
# ticket status values (ServedQuery.status)
# ---------------------------------------------------------------------------
STATUS_OK = "ok"  # served by the engine
STATUS_SHED = "shed"  # rejected at admission (tenant queue full)
STATUS_ERROR = "error"  # typed serving failure surfaced through the ticket


# ---------------------------------------------------------------------------
# typed exceptions — the serving layer never raises bare asserts
# ---------------------------------------------------------------------------
class ServingError(RuntimeError):
    """Base class for every typed serving-tier failure."""


class ServerConfigError(ServingError):
    """A front-end was constructed or called with invalid knobs."""


class SchemaMismatchError(ServingError):
    """`swap_engine` was handed an engine with a different query schema."""


class ServerClosedError(ServingError):
    """submit() after close() — the server no longer admits queries."""


class QueueFullError(ServingError):
    """A bounded tenant queue is full and shedding is disabled."""


@runtime_checkable
class Server(Protocol):
    """The unified front-end contract (structural; see module docstring).

    `MicroBatcher` (mode="sync"), `AsyncServer` (mode="pipelined"), and
    `ConcurrentFrontend` (mode="concurrent") all conform; the parity suite
    in tests/test_torch_serving.py runs one query stream through all
    three and asserts bit-identical results and counters.
    """

    def submit(self, query: dict, *, tenant: int = 0) -> int:
        """Enqueue one user query; returns a ticket for `result()`."""
        ...

    def result(self, ticket: int, *, timeout: float | None = None
               ) -> "ServedQuery":
        """Redeem `ticket` (exactly once); blocks/flushes until resolved."""
        ...

    def serve_many(self, queries, *, tenant: int = 0) -> list["ServedQuery"]:
        """Submit + flush + collect, in submission order."""
        ...

    def flush(self) -> None:
        """Drain every submitted query to a resolved ticket."""
        ...

    def close(self) -> None:
        """Flush, then stop admitting queries (idempotent)."""
        ...

    def stats(self) -> dict:
        """One stats schema for every mode (see docs/SERVING.md) — the
        `stats_view` of `snapshot()`."""
        ...

    def snapshot(self) -> dict:
        """The full telemetry snapshot (docs/OBSERVABILITY.md)."""
        ...

    def take_trace(self) -> list:
        """Return-and-clear the completed-ticket `TicketTrace` records
        (each carries its stage-span chain when tracing is on)."""
        ...

    def swap_engine(self, engine) -> None:
        """Atomically swap engine epochs between buckets (LiveCatalog)."""
        ...


_MODES = ("sync", "pipelined", "concurrent")


def stats_view(snapshot: dict) -> dict:
    """The legacy `stats()` dict as a view over a telemetry `snapshot()`.

    Every front-end's `stats()` is this one function applied to its
    `MetricsRegistry.snapshot()` — the single place the unified key
    schema is defined, so the three modes can never drift apart again.
    All modes return the SAME key set; knobs that don't apply to a mode
    take their degenerate values (``depth=1`` / ``in_flight=0`` for the
    synchronous batcher, ``queue_depth=None`` / ``drain_chunk=None`` for
    the single-tenant front-ends). Derived ratios (`padding_fraction`,
    `cache_hit_rate`) are computed here, not stored.
    """
    served = int(snapshot.get("serving.served", 0))
    padded = int(snapshot.get("serving.padded", 0))
    hits = int(snapshot.get("cache.hits", 0))
    lookups = int(snapshot.get("cache.lookups", 0))
    total = served + padded
    drain = snapshot.get("serving.drain_chunk")
    return {
        "mode": snapshot.get("serving.mode"),
        "closed": bool(snapshot.get("serving.closed", False)),
        "n_submitted": int(snapshot.get("serving.submitted", 0)),
        "n_served": served,
        "n_shed": int(snapshot.get("serving.shed", 0)),
        "n_errors": int(snapshot.get("serving.errors", 0)),
        "n_pending": int(snapshot.get("serving.pending", 0)),
        "n_padded": padded,
        "n_batches": int(snapshot.get("serving.batches", 0)),
        "padding_fraction": padded / total if total else 0.0,
        "cache_hits": hits,
        "cache_lookups": lookups,
        "cache_hit_rate": hits / lookups if lookups else 0.0,
        "per_tenant": snapshot.get("serving.per_tenant", {}),
        "depth": int(snapshot.get("serving.ring_depth", 1)),
        "coalesce": int(snapshot.get("serving.coalesce", 1)),
        "in_flight": int(snapshot.get("serving.in_flight", 0)),
        "queue_depth": snapshot.get("serving.queue_depth"),
        "queued_now": snapshot.get("serving.queued_now", {}),
        "drain_chunk": None if drain is None else int(drain),
        "last_error": snapshot.get("serving.last_error"),
    }


def make_server(engine, mode: str = "sync", **knobs) -> "Server":
    """Construct a serving front-end by mode — the one public entry point.

    Args:
      engine: the `RecSysEngine` to serve from.
      mode: ``"sync"`` (MicroBatcher: one bucket at a time),
        ``"pipelined"`` (AsyncServer: depth-N ring of in-flight buckets),
        or ``"concurrent"`` (ConcurrentFrontend: per-tenant bounded queues
        draining through a thread into the pipelined ring, with admission
        control and load shedding).
      **knobs: mode-scoped keyword knobs —
        every mode: ``max_batch``, ``buckets``, ``trace`` (stage-span
        tracing, default True), ``registry`` (a shared
        `repro_torch.obs.MetricsRegistry`; default: one per server);
        pipelined + concurrent: ``depth``, ``coalesce``;
        concurrent only: ``tenants``, ``queue_depth``, ``drain_chunk``,
        ``shed``, ``autostart``.
        An unknown knob (or a knob outside its mode) raises
        `ServerConfigError` instead of being silently ignored.

    Returns:
      a `Server`-conforming front-end.
    """
    from repro_torch.serving.async_server import AsyncServer
    from repro_torch.serving.batcher import MicroBatcher
    from repro_torch.serving.frontend import ConcurrentFrontend

    classes = {"sync": MicroBatcher, "pipelined": AsyncServer,
               "concurrent": ConcurrentFrontend}
    every = {"max_batch", "buckets", "trace", "registry"}
    allowed = {
        "sync": every,
        "pipelined": every | {"depth", "coalesce"},
        "concurrent": every | {"depth", "coalesce", "tenants",
                               "queue_depth", "drain_chunk", "shed",
                               "autostart"},
    }
    if mode not in _MODES:
        raise ServerConfigError(
            f"unknown serving mode {mode!r}; expected one of {_MODES}")
    extra = set(knobs) - allowed[mode]
    if extra:
        raise ServerConfigError(
            f"knobs {sorted(extra)} are not valid for mode={mode!r} "
            f"(allowed: {sorted(allowed[mode])})")
    return classes[mode](engine, **knobs)
