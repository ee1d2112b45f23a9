"""Serving layer of the port: the RecSys engine, its hot caches and
the three front-ends over it, plus the LM serving steps (`engine.py`).

Every front-end implements the one `Server` protocol (submit -> ticket,
result(ticket), flush, close, stats) and is constructed through
`make_server(engine, mode="sync" | "pipelined" | "concurrent", **knobs)`:
the synchronous `MicroBatcher`, the pipelined `AsyncServer` ring (the
staged lookup/scan/rank steps queued on the card while the host stacks
the next bucket), and the threaded multi-tenant `ConcurrentFrontend` with
bounded per-tenant queues and load shedding. `LoadGen` replays open-loop
traffic into any of them. `LiveCatalog` versions the item catalog with a
bounded delta shard, tombstones and epoch compaction, serving the same
bits as an engine rebuilt from scratch while the catalog churns;
`TieredCatalog` serves a memmapped base shard through an int8 RAM pool
and the f32 hot cache. `OnlineTrainer` trains the filtering model while
the catalog serves and folds its item rows in; `ShadowHarness` holds the
live engine against a cold rebuild of the trainer's parameters
(`rebuild_from_params`). Names follow `repro.serving`.
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
from repro_torch.serving.catalog import (
    DeltaFullError,
    DeltaShard,
    LiveCatalog,
    compact_engine,
    empty_delta,
    engine_apply_updates,
    engine_refresh_model,
    materialize,
    rebuild_reference,
)
from repro_torch.serving.hot_cache import (
    CacheStats,
    HotRowCache,
    build_hot_cache,
    cached_embedding_bag,
    cached_lookup,
    invalidate_rows,
    pin_rows,
    top_ids_by_freq,
)
from repro_torch.serving.online import OnlineTrainer
from repro_torch.serving.shadow import (
    ShadowHarness,
    ShadowRecord,
    rebuild_from_params,
)
from repro_torch.serving.tiered import (
    BaseShard,
    BaseShardWriter,
    TieredCatalog,
    open_base_shard,
    write_base_shard,
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
    "BaseShard",
    "BaseShardWriter",
    "CacheStats",
    "ConcurrentFrontend",
    "DeltaFullError",
    "DeltaShard",
    "HotRowCache",
    "LiveCatalog",
    "LoadGen",
    "LoadSummary",
    "MicroBatcher",
    "OnlineTrainer",
    "QueueFullError",
    "RecSysEngine",
    "SchemaMismatchError",
    "ServeResult",
    "ServedQuery",
    "Server",
    "ServerClosedError",
    "ServerConfigError",
    "ServingError",
    "ShadowHarness",
    "ShadowRecord",
    "TicketTrace",
    "TieredCatalog",
    "build_hot_cache",
    "cached_embedding_bag",
    "cached_lookup",
    "compact_engine",
    "default_buckets",
    "empty_delta",
    "engine_apply_updates",
    "engine_refresh_model",
    "filter_step",
    "hit_rate",
    "invalidate_rows",
    "lookup_step",
    "make_server",
    "materialize",
    "open_base_shard",
    "pin_rows",
    "rank_stage_step",
    "rank_step",
    "rebuild_from_params",
    "rebuild_reference",
    "scan_step",
    "serve_step",
    "stats_view",
    "summarize_trace",
    "top_ids_by_freq",
    "write_base_shard",
]
