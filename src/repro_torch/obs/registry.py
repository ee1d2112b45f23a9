"""The metrics registry: one home for every serving-stack counter.

A copy of `repro/obs/registry.py` (numpy and the standard library only).

iMARS's headline numbers are per-stage latency/energy breakdowns; RecNMP
and MicroRec justify their designs with measured locality and per-stage
profiles. Before this module the reproduction could not produce either:
every subsystem kept an ad-hoc counter dict (hot-cache hits on the
batcher, compaction pauses on the catalog, staleness lists on the
trainer) with no shared schema and no export path. `MetricsRegistry` is
the single sink they all report into, designed so the *hot serving path
pays almost nothing* (the reference gates it in benchmarks/obs_overhead.py:
instrumented serving must hold >= 0.95x uninstrumented qps):

  * **counters** (`count`) and **histograms** (`observe`) write to
    per-thread shards — a plain dict bump / one numpy bucket increment,
    no lock on the hot path — merged only when a `snapshot()` is taken;
  * **gauges** (`gauge`) and **info** entries (`info`, non-numeric) are
    last-write-wins under a short lock — they are set from *collector*
    callbacks (`register_collector`), which run at snapshot time, so
    subsystems keep their cheap plain-int attributes and only translate
    them to registry keys when somebody actually looks;
  * **histograms** are log2-bucketed (bucket i counts observations
    ``v <= HIST_BASE * 2**i``), so a 48-cell int64 array spans 1 us to
    ~3 days of latency with constant memory and O(1) updates;
  * **events** (`event`) append structured records (compaction, epoch
    publication, fold) to a bounded in-memory log exportable as JSONL.

Naming convention (docs/OBSERVABILITY.md): dotted lowercase
``subsystem.metric[_unit]`` — e.g. ``serving.served``,
``cache.hits``, ``catalog.compact_pause_s``, ``online.staleness_ms``.

Exporters: `snapshot()` (flat dict: merged counters + gauges + info +
per-histogram summary stats), `to_prometheus()` (text exposition), and
`EventLog.to_jsonl()` / `write_jsonl()` for the event stream.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Callable

import numpy as np

# log2 histogram buckets: bucket i counts v <= HIST_BASE * 2**i; the last
# bucket absorbs overflow. 48 buckets from 1 us cover ~2.8e8 s.
HIST_BASE = 1e-6
HIST_BUCKETS = 48

# bounded event log: newest-wins would reorder history, so the log keeps
# the most recent EVENT_CAP records and counts what it dropped
EVENT_CAP = 10_000


def _bucket_index(value: float) -> int:
    """Histogram bucket for one observation (0 for v <= HIST_BASE)."""
    if value <= HIST_BASE:
        return 0
    return min(HIST_BUCKETS - 1,
               max(0, math.ceil(math.log2(value / HIST_BASE))))


def bucket_upper_bounds() -> list[float]:
    """The ``le`` upper bound of every histogram bucket, ascending."""
    return [HIST_BASE * 2.0 ** i for i in range(HIST_BUCKETS)]


class _Hist:
    """One thread's shard of one histogram (unsynchronized by design)."""

    __slots__ = ("counts", "total", "n", "max")

    def __init__(self):
        self.counts = np.zeros(HIST_BUCKETS, np.int64)
        self.total = 0.0
        self.n = 0
        self.max = 0.0

    def observe(self, value: float) -> None:
        self.counts[_bucket_index(value)] += 1
        self.total += value
        self.n += 1
        if value > self.max:
            self.max = value


class _Shard:
    """Per-thread metric shard: counters + histograms, no locking.

    Only the owning thread writes a shard; `snapshot()` reads every shard
    (tearing between a counter bump and its histogram twin is acceptable
    for telemetry — each individual value is always internally sane).
    """

    __slots__ = ("counters", "hists")

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.hists: dict[str, _Hist] = {}


class EventLog:
    """Bounded structured event log (compactions, epoch swaps, folds).

    `append` is O(1) and thread-safe; the log keeps the most recent
    `EVENT_CAP` records (`n_dropped` counts evictions). Each record is a
    JSON-serializable dict carrying ``seq`` (monotonic), ``unix_time``,
    ``kind``, and the caller's fields — exported via `to_jsonl()` /
    `write_jsonl()` for offline tooling.
    """

    def __init__(self, cap: int = EVENT_CAP):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=cap)
        self._seq = 0
        self.n_dropped = 0

    def append(self, kind: str, **fields) -> dict:
        rec = {"seq": 0, "unix_time": time.time(), "kind": str(kind),
               **fields}
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self.n_dropped += 1
            self._events.append(rec)
        return rec

    def records(self) -> list[dict]:
        """The retained events, oldest first (a copy)."""
        with self._lock:
            return list(self._events)

    def to_jsonl(self) -> str:
        return "".join(json.dumps(r, sort_keys=True) + "\n"
                       for r in self.records())

    def write_jsonl(self, path) -> int:
        """Write the retained events to `path`; returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        return len(recs)


class MetricsRegistry:
    """Thread-safe metrics sink with per-thread shards (module docstring).

    The write API (`count`, `observe`, `gauge`, `info`, `event`) is safe
    from any thread; `snapshot()` merges every shard into one flat dict.
    Collectors registered via `register_collector` run at the top of each
    snapshot so lazy subsystems can publish gauges just-in-time.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._shards: list[_Shard] = []
        self._gauges: dict[str, float] = {}
        self._info: dict[str, object] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []
        self.events = EventLog()

    # -- hot-path writes (per-thread shards, no lock) -------------------
    def _shard(self) -> _Shard:
        shard = getattr(self._local, "shard", None)
        if shard is None:
            shard = _Shard()
            self._local.shard = shard
            with self._lock:
                self._shards.append(shard)
        return shard

    def count(self, name: str, n: float = 1) -> None:
        """Add `n` to the counter `name` (monotonic, merged at snapshot)."""
        counters = self._shard().counters
        counters[name] = counters.get(name, 0) + n

    def observe(self, name: str, value: float) -> None:
        """Record one observation into the log2-bucketed histogram."""
        hists = self._shard().hists
        h = hists.get(name)
        if h is None:
            h = hists[name] = _Hist()
        h.observe(float(value))

    # -- snapshot-time writes (locked, last-write-wins) -----------------
    def gauge(self, name: str, value) -> None:
        """Set the gauge `name` (int values stay int in the snapshot)."""
        with self._lock:
            self._gauges[name] = value if isinstance(value, int) \
                else float(value)

    def info(self, name: str, value) -> None:
        """Attach a non-numeric entry (mode strings, per-tenant dicts);
        info entries ride `snapshot()` but are skipped by Prometheus."""
        with self._lock:
            self._info[name] = value

    def event(self, kind: str, **fields) -> dict:
        """Append one structured record to the event log (see EventLog)."""
        return self.events.append(kind, **fields)

    def register_collector(self, fn: Callable) -> None:
        """Register `fn(registry)` to run at the top of every snapshot —
        the bridge from a subsystem's plain-int counters to gauges."""
        with self._lock:
            self._collectors.append(fn)

    # -- merged reads ---------------------------------------------------
    def _merged(self) -> tuple[dict, dict]:
        """(counters, histograms) summed across every thread shard."""
        with self._lock:
            shards = list(self._shards)
        counters: dict[str, float] = {}
        hists: dict[str, _Hist] = {}
        for shard in shards:
            for k, v in shard.counters.items():
                counters[k] = counters.get(k, 0) + v
            for k, h in shard.hists.items():
                m = hists.get(k)
                if m is None:
                    m = hists[k] = _Hist()
                m.counts = m.counts + h.counts
                m.total += h.total
                m.n += h.n
                m.max = max(m.max, h.max)
        return counters, hists

    @staticmethod
    def _quantile(h: _Hist, q: float) -> float:
        """Upper bucket bound at quantile `q` (conservative estimate)."""
        if h.n == 0:
            return 0.0
        target = q * h.n
        cum = np.cumsum(h.counts)
        idx = int(np.searchsorted(cum, target))
        return HIST_BASE * 2.0 ** min(idx, HIST_BUCKETS - 1)

    def snapshot(self) -> dict:
        """Run collectors, then merge everything into one flat dict.

        Counters and gauges land under their own names; each histogram
        `h` expands to ``h.count`` / ``h.sum`` / ``h.mean`` / ``h.p50`` /
        ``h.p99`` / ``h.max``; info entries ride verbatim. The dict is
        JSON-serializable — benchmarks embed it as the ``telemetry`` key
        of BENCH_*.json (validated by `bench_io.check_telemetry_schema`).
        """
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)
        counters, hists = self._merged()
        out: dict = {}
        out.update(counters)
        with self._lock:
            out.update(self._gauges)
            out.update(self._info)
        for name, h in sorted(hists.items()):
            out[f"{name}.count"] = int(h.n)
            out[f"{name}.sum"] = float(h.total)
            out[f"{name}.mean"] = float(h.total / h.n) if h.n else 0.0
            out[f"{name}.p50"] = self._quantile(h, 0.50)
            out[f"{name}.p99"] = self._quantile(h, 0.99)
            out[f"{name}.max"] = float(h.max)
        out["events.count"] = len(self.events.records())
        out["events.dropped"] = self.events.n_dropped
        return out

    def to_prometheus(self, prefix: str = "repro") -> str:
        """Prometheus-style text exposition of the numeric state.

        Counters export as ``counter``, gauges as ``gauge``, histograms
        as cumulative ``_bucket{le=...}`` series + ``_sum`` / ``_count``.
        Info entries are skipped (Prometheus values must be numeric).
        """
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)
        counters, hists = self._merged()
        with self._lock:
            gauges = dict(self._gauges)

        def metric(name: str) -> str:
            safe = "".join(c if c.isalnum() or c == "_" else "_"
                           for c in name)
            return f"{prefix}_{safe}"

        lines = []
        for name in sorted(counters):
            m = metric(name)
            lines += [f"# TYPE {m} counter", f"{m} {counters[name]:g}"]
        for name in sorted(gauges):
            v = gauges[name]
            m = metric(name)
            lines += [f"# TYPE {m} gauge",
                      f"{m} {v:g}" if isinstance(v, (int, float))
                      else f"{m} 0"]
        bounds = bucket_upper_bounds()
        for name in sorted(hists):
            h, m = hists[name], metric(name)
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            for i, le in enumerate(bounds):
                cum += int(h.counts[i])
                lines.append(f'{m}_bucket{{le="{le:g}"}} {cum}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {int(h.n)}')
            lines.append(f"{m}_sum {h.total:g}")
            lines.append(f"{m}_count {int(h.n)}")
        return "\n".join(lines) + "\n"
