"""Serving layer of the port: the frozen RecSys engine, its hot caches and
the three front-ends over it, plus the LM serving steps (`engine.py`).

Every front-end implements the one `Server` protocol (submit -> ticket,
result(ticket), flush, close, stats) and is constructed through
`make_server(engine, mode="sync" | "pipelined" | "concurrent", **knobs)`:
the synchronous `MicroBatcher`, the pipelined `AsyncServer` ring (the
staged lookup/scan/rank steps queued on the card while the host stacks
the next bucket), and the threaded multi-tenant `ConcurrentFrontend` with
bounded per-tenant queues and load shedding. `LoadGen` replays open-loop
traffic into any of them. Names follow `repro.serving`; its live-catalog,
tiered, online and shadow parts are not ported yet.
"""
from repro_torch.serving.async_server import AsyncServer
from repro_torch.serving.batcher import (
    MicroBatcher,
    ServedQuery,
    default_buckets,
)
from repro_torch.serving.frontend import ConcurrentFrontend, TicketTrace
from repro_torch.serving.load_gen import LoadGen, LoadSummary, summarize_trace
from repro_torch.serving.server import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED,
    QueueFullError,
    SchemaMismatchError,
    Server,
    ServerClosedError,
    ServerConfigError,
    ServingError,
    make_server,
    stats_view,
)
from repro_torch.serving.hot_cache import (
    CacheStats,
    HotRowCache,
    build_hot_cache,
    cached_embedding_bag,
    top_ids_by_freq,
)
from repro_torch.serving.recsys_engine import (
    RecSysEngine,
    ServeResult,
    filter_step,
    hit_rate,
    lookup_step,
    rank_stage_step,
    rank_step,
    scan_step,
    serve_step,
)

__all__ = [
    "STATUS_ERROR",
    "STATUS_OK",
    "STATUS_SHED",
    "AsyncServer",
    "CacheStats",
    "ConcurrentFrontend",
    "HotRowCache",
    "LoadGen",
    "LoadSummary",
    "MicroBatcher",
    "QueueFullError",
    "RecSysEngine",
    "SchemaMismatchError",
    "ServeResult",
    "ServedQuery",
    "Server",
    "ServerClosedError",
    "ServerConfigError",
    "ServingError",
    "TicketTrace",
    "build_hot_cache",
    "cached_embedding_bag",
    "default_buckets",
    "filter_step",
    "hit_rate",
    "lookup_step",
    "make_server",
    "rank_stage_step",
    "rank_step",
    "scan_step",
    "serve_step",
    "stats_view",
    "summarize_trace",
    "top_ids_by_freq",
]
