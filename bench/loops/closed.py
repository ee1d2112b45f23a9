"""The closed loop that drives the system: `depth` batches in flight (the
mix's ``loop``: ``"closed"``; its ``depth`` and ``batch``).

Each step stages a pool batch on the device (non-blocking copies from
pinned host memory), dispatches it through the system's entry, queues the
copies of its answers (final ids and CTR scores) into pinned host buffers
and records an event; then, with `depth` batches in flight, waits for the
oldest batch's answers to land on the host before it dispatches the next.
This is how a bulk scorer drives the engine: the host stages and
dispatches one batch while the card runs the one before.

A batch's latency runs from its dispatch to its answers on the host. The
window counts a batch whose answers landed before it closed; batches still
in flight when it closes land after it and count nowhere. The loop's
end-to-end metrics (`end_to_end`): ``qps``, the queries of the batches that
landed in the window over its seconds, and ``batch_p95_ms``, the 95th
percentile of their latencies (each query waits for its batch, so this is
the queries' tail too).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Landed:
    slot: int  # the pool batch served
    dispatched: float  # host clock at dispatch
    serve_s: float  # host seconds inside the entry call
    landed: float = 0.0  # host clock when the answers were on the host
    # the system's result (device tensors) and the host buffers its answers
    # landed in, until `on_land` has seen them
    result: object = None
    answers: tuple = ()


@dataclass
class Window:
    start: float
    end: float
    batch: int  # queries a batch
    landed: list = field(default_factory=list)  # Landed, in the window
    dispatched: int = 0  # batches dispatched while it was open

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def attempted(self) -> int:
        """Queries dispatched while the window was open."""
        return self.batch * self.dispatched

    @property
    def queries(self) -> int:
        """Queries whose answers landed in the window."""
        return self.batch * len(self.landed)


class _HostEvent:
    """The CPU stand-in for a CUDA event: the work is done at dispatch."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _span(name: str, on: bool):
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def end_to_end(window: Window) -> dict:
    """The window's end-to-end values by metric name."""
    lat_ms = [(b.landed - b.dispatched) * 1e3 for b in window.landed]
    if not lat_ms:
        return {}
    return {"qps": window.queries / window.seconds,
            "batch_p95_ms": float(np.percentile(lat_ms, 95))}


class Loop:
    """Serves the pool's batches in turn, `depth` in flight."""

    def __init__(self, system, pool: list, traffic: dict, device):
        self.system, self.depth = system, traffic["depth"]
        self.batch, self.device = traffic["batch"], device
        cuda = device.type == "cuda"
        self.pool = [{k: torch.from_numpy(v).pin_memory() if cuda
                      else torch.from_numpy(v) for k, v in b.items()}
                     for b in pool]
        # a ring of answer buffers: one a batch in flight, and one more for
        # the batch being dispatched
        self.ring = [system.answer_buffers(pin=cuda)
                     for _ in range(self.depth + 1)]
        self.dispatched = 0
        self._event = (lambda: torch.cuda.Event()) if cuda else _HostEvent

    def run(self, *, batches: int | None = None, seconds: float | None = None,
            on_land=None, spans: bool = False) -> Window:
        """Serve `batches` batches, or until `seconds` have passed; then
        wait for every batch in flight. `on_land(landed, in_window)` sees
        each batch as its answers land."""
        inflight = []
        start = time.perf_counter()
        end = start + seconds if seconds is not None else float("inf")
        window = Window(start=start, end=end, batch=self.batch)
        n = 0
        with _span("bench.window", spans):
            while (time.perf_counter() < end if batches is None
                   else n < batches):
                inflight.append(self._dispatch(spans))
                n += 1
                window.dispatched += 1
                if len(inflight) >= self.depth:
                    self._land(inflight.pop(0), window, on_land, spans)
            while inflight:
                self._land(inflight.pop(0), window, on_land, spans)
        if seconds is None:
            window.end = time.perf_counter()
        return window

    def _dispatch(self, spans: bool):
        no = self.dispatched
        self.dispatched += 1
        slot = no % len(self.pool)
        t0 = time.perf_counter()
        with _span("bench.stage", spans):
            inputs = {k: v.to(self.device, non_blocking=True)
                      for k, v in self.pool[slot].items()}
        with _span("bench.serve", spans):
            t1 = time.perf_counter()
            result = self.system.serve(inputs)
            t2 = time.perf_counter()
        with _span("bench.fetch", spans):
            answers = self.ring[no % len(self.ring)]
            for dst, src in zip(answers, self.system.answers(result)):
                dst.copy_(src, non_blocking=True)
            event = self._event()
            event.record()
        return Landed(slot=slot, dispatched=t0, serve_s=t2 - t1,
                      result=result, answers=answers), event

    def _land(self, item, window: Window, on_land, spans: bool):
        landed, event = item
        with _span("bench.wait", spans):
            event.synchronize()
        landed.landed = time.perf_counter()
        in_window = landed.landed <= window.end
        if in_window:
            window.landed.append(landed)
        if on_land is not None:
            on_land(landed, in_window)
        # the result's device tensors and the ring buffer go back to their
        # owners; `on_land` keeps a copy of what it needs
        landed.result, landed.answers = None, ()
