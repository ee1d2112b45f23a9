"""Pipelined (double-buffered) serving over the staged iMARS pipeline.

Ported from `repro/serving/async_server.py`. iMARS's end-to-end win comes
from keeping the filtering and ranking stages busy *simultaneously* (paper
Fig. 3). The synchronous `MicroBatcher` serializes in software: each
bucket is stacked on the host, served, and copied back before the next is
even assembled, so the host waits while the device scans and the device
waits while the host stacks.

`AsyncServer` recovers the overlap with eager PyTorch's asynchronous
launches on one stream (the caller's current stream, as every kernel
wrapper of the port launches on) — no threads, no side stream:

  * each bucket is stacked in numpy, staged into pinned host buffers and
    copied to the device without blocking (`batcher.stage_batch`), then
    dispatched through the **staged** serve pipeline (`lookup_step` ->
    `scan_step` -> `rank_stage_step`, `serve_step` split at its stage
    boundaries), and its items, scores and blocks-touched are queued back
    into pinned buffers behind one event (`batcher.HostCopy`);
  * nothing waits until the ring holds `depth` buckets: while bucket i
    runs on the device, the host is already stacking bucket i+1 and
    queueing its stages;
  * retiring a bucket waits on its event — the only host sync per bucket —
    and fans its rows out to the tickets;
  * the hot-cache accumulator stays on the device, threaded through the
    stages exactly like the synchronous path, and is read only by
    `stats()` / `snapshot()`.

Nothing on the dispatch path may make the host wait: a pageable
host-to-device copy, a `.item()` or a device-to-host read there would
wait for every bucket already queued and undo the overlap (checked on the
card under `torch.cuda.set_sync_debug_mode("error")`).

`coalesce` concatenates up to that many full buckets into one dispatch:
on an engine whose queries are blocked over a mesh axis
(`RecSysEngine.shard(..., query_axis=...)`) it defaults to that axis' size,
so each rank scans one bucket's worth of queries a dispatch; else to 1.

Bit-for-bit contract (tested in tests/test_torch_serving.py): pipelined
serving returns exactly the items, scores, and cache counters the
synchronous `MicroBatcher` returns for the same query stream — the ring,
the stage split, and coalescing are pure execution knobs.

`swap_engine` (inherited from `MicroBatcher`) never touches in-flight
entries: those buckets finish on the engine they were dispatched against,
and every later dispatch serves the new one.
"""
from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.obs import MetricsRegistry
from repro_torch.serving.batcher import HostCopy, MicroBatcher, stage_batch
from repro_torch.serving.recsys_engine import (
    RecSysEngine,
    lookup_step,
    rank_stage_step,
    scan_step,
)
from repro_torch.serving.server import ServerConfigError
from repro_torch.utils import mesh_axis_size


class _InFlight(NamedTuple):
    """One dispatched (possibly coalesced) bucket riding the ring."""

    parts: tuple  # ((chunk, bucket), ...) — chunk = [(ticket, query), ...]
    out: HostCopy  # items, scores (and blocks-touched) on their way back
    has_blocks: bool = False  # the copy carries the blocks-touched counts
    t_bucket: float = 0.0  # host time the buckets were taken off the queue
    t_dispatch: float = 0.0  # host time the staged pipeline was dispatched


class AsyncServer(MicroBatcher):
    """Pipelined micro-batching server over a `RecSysEngine`.

    Drop-in for `MicroBatcher` (same submit/result/serve_many API, same
    bucketing, same counters) with a ring of up to `depth` in-flight
    buckets dispatched through the staged serve pipeline.

    Args:
      engine: the serving engine.
      max_batch / buckets: bucketing, as `MicroBatcher`.
      depth: in-flight ring size; 1 degenerates to synchronous serving,
        2 (default) double-buffers host work against device compute.
      coalesce: number of full buckets fused into one dispatch (default:
        the engine's query-axis size when it is sharded with
        `query_axis=...`, else 1).

    Invariant: results bit-match the synchronous `MicroBatcher` for any
    depth / coalesce / bucket mix (tested).
    """

    mode = "pipelined"

    def __init__(self, engine: RecSysEngine, *, max_batch: int = 256,
                 buckets: Sequence[int] | None = None, depth: int = 2,
                 coalesce: int | None = None, trace: bool = True,
                 registry: MetricsRegistry | None = None):
        super().__init__(engine, max_batch=max_batch, buckets=buckets,
                         trace=trace, registry=registry)
        if depth < 1:
            raise ServerConfigError(f"ring depth must be >= 1, got {depth}")
        if coalesce is None:
            routed = (engine.nns_mesh is not None
                      and engine.nns_query_axis is not None)
            coalesce = (mesh_axis_size(engine.nns_mesh,
                                       engine.nns_query_axis)
                        if routed else 1)
        if coalesce < 1:
            raise ServerConfigError(f"coalesce must be >= 1, got {coalesce}")
        self.depth = depth
        self.coalesce = coalesce
        self._ring: deque[_InFlight] = deque()

    # ------------------------------------------------------------------
    @property
    def in_flight(self) -> int:
        """Dispatched-but-unretired buckets currently riding the ring."""
        return len(self._ring)

    def flush(self) -> None:
        """Drain the queue, keeping up to `depth` buckets in flight.

        Dispatches queue work without waiting; the only host syncs are the
        retirements, each overlapped with the following buckets' host prep
        and device compute. Returns with every pending ticket's result on
        the host, like the synchronous flush.
        """
        while self._pending:
            self._ring.append(self._dispatch(self._take_parts()))
            while len(self._ring) >= self.depth:
                self._retire()
        while self._ring:
            self._retire()

    # ------------------------------------------------------------------
    def _take_parts(self) -> list[tuple[list, int]]:
        """Pop 1..coalesce chunks off the queue as (chunk, bucket) parts.

        Only *full* `max_batch` chunks coalesce (so the set of batch
        shapes stays small); a short tail always ships alone in its own
        pow2 bucket.
        """
        parts = []
        while self._pending and len(parts) < self.coalesce:
            chunk = self._pending[: self.max_batch]
            if parts and len(chunk) < self.max_batch:
                break  # tail chunk: dispatch separately
            self._pending = self._pending[self.max_batch:]
            bucket = next(b for b in self.buckets if b >= len(chunk))
            parts.append((chunk, bucket))
        return parts

    def _dispatch(self, parts: list[tuple[list, int]]) -> _InFlight:
        """Stack `parts` into one batch, stage it on the device, queue the
        three stages and the copies of their results back to the host."""
        t_bucket = time.perf_counter() if self.trace else 0.0
        stacked = [self._stack_np([q for _, q in chunk], bucket)
                   for chunk, bucket in parts]
        host = (stacked[0] if len(stacked) == 1 else
                {k: np.concatenate([s[k] for s in stacked])
                 for k in stacked[0]})
        batch = stage_batch(host, self.engine.device)
        u, pooled, self._stats = lookup_step(self.engine, batch, self._stats)
        nns = scan_step(self.engine, u)
        items, top, self._stats = rank_stage_step(
            self.engine, batch, nns.indices, u, pooled, self._stats)
        blocks = getattr(nns, "blocks_touched", None)
        out = HostCopy([items, top.scores]
                       + ([blocks] if blocks is not None else []))
        for chunk, bucket in parts:
            self.n_served += len(chunk)
            self.n_padded += bucket - len(chunk)
            self.n_batches += 1
        return _InFlight(parts=tuple(parts), out=out,
                         has_blocks=blocks is not None, t_bucket=t_bucket,
                         t_dispatch=(time.perf_counter() if self.trace
                                     else 0.0))

    def _retire(self) -> None:
        """Wait for the oldest in-flight bucket and fan out its results.

        Span semantics for the ring: the results retire *together* at the
        one host sync, so the ``scan`` boundary lands on the retirement
        and ``rank`` is ~0 — the whole in-flight device wait shows up as
        dispatch -> scan. Observing the real scan/rank edge would need an
        extra wait, which is exactly the serialization the ring removes.
        """
        inf = self._ring.popleft()
        host = inf.out.numpy()  # the one host sync per bucket
        items, scores = host[0], host[1]
        if self.trace:
            t_sync = time.perf_counter()
            self.registry.observe("serving.stage.dispatch_s",
                                  inf.t_dispatch - inf.t_bucket)
            self.registry.observe("serving.stage.scan_s",
                                  t_sync - inf.t_dispatch)
            if inf.has_blocks:
                self._count_blocks(host[2])
            tail = (("bucket", inf.t_bucket),
                    ("dispatch", inf.t_dispatch),
                    ("scan", t_sync), ("rank", t_sync))
            for chunk, _ in inf.parts:
                for ticket, _ in chunk:
                    self._spans.setdefault(ticket, []).extend(tail)
        row = 0
        for chunk, bucket in inf.parts:
            self._observe(chunk, items[row: row + bucket])
            for j, (ticket, _) in enumerate(chunk):
                self._resolve(ticket, items[row + j], scores[row + j])
            row += bucket

    # ------------------------------------------------------------------
    def _collect(self, reg: MetricsRegistry) -> None:
        """`MicroBatcher._collect` + the ring knobs and occupancy."""
        super()._collect(reg)
        reg.gauge("serving.ring_depth", self.depth)
        reg.gauge("serving.coalesce", self.coalesce)
        reg.gauge("serving.in_flight", self.in_flight)
