"""Observability: the unified telemetry layer for the serving stack.

A copy of `repro/obs`: the port's front-ends report into the same
registry and span schema. Beyond the copy, `span` names the serve step's
stages and NNS plans in a `torch.profiler` trace (docs/OBSERVABILITY.md).

One `MetricsRegistry` per server (or one shared across a serving stack)
is the single home for every counter the subsystems used to keep ad-hoc
— hot-cache hits, pruned-scan blocks touched, delta-overlay occupancy,
tier residency, compaction pauses, shed/error accounting, fold staleness
— plus per-request **stage spans** threaded through the ticket lifecycle
(submit -> admit -> bucket -> dispatch -> scan -> rank -> resolve) in all
three `make_server` modes. Exporters: `MetricsRegistry.snapshot()` (flat
dict, embedded in BENCH_*.json), `to_prometheus()` (text exposition),
`EventLog` JSONL, and the reference's `tools/obs_report.py` breakdown
CLI. In the reference the layer is overhead-gated
(benchmarks/obs_overhead.py); see docs/OBSERVABILITY.md.
"""
from repro_torch.obs.registry import (
    EventLog,
    MetricsRegistry,
    bucket_upper_bounds,
)
from repro_torch.obs.tracing import (
    STAGES,
    TicketTrace,
    dump_trace,
    span,
    stage_durations,
    trace_record,
    well_ordered,
)

__all__ = [
    "STAGES",
    "EventLog",
    "MetricsRegistry",
    "TicketTrace",
    "bucket_upper_bounds",
    "dump_trace",
    "span",
    "stage_durations",
    "trace_record",
    "well_ordered",
]
