"""Device time by the program's own spans: a second profiled run of the
closed loop, after `bench/tracing.py`'s, shared by the readers that need it.

The program names the work of its serve step with spans that are
`torch.profiler.record_function` ranges while a profiler records: `serve`
around one batch (one a batch: the batch's identifier), `serve.lookup`,
`serve.scan` and `serve.rank` around its stages, `nns.dense` /
`nns.stream` around the NNS plan that ran, `nns.dense.select` and
`nns.stream.bounds` inside them. The loop adds its own (`bench.window`,
`bench.stage`, `bench.serve`, `bench.fetch`, `bench.wait`).

Each device operation (kernel, copy, fill) is put down to the innermost
span open on the host thread when it was launched. The profiler links
most operations to the innermost operator or span open at their launch,
whose start then lies in that span; a kernel launched from a library of
its own (the port's CUDA kernels, bound with ctypes) is linked to no
operator, and its launch on the CUDA runtime, found by the correlation id
the operation shares with it, gives the thread and the time instead.
Time on the device that overlaps another host span (with two batches in
flight it always does) plays no part. A span's time is inclusive: the
operations launched in it or in any span inside it.

`span_times(ctx)` runs the loop for the mix's `trace_batches` batches
under the profiler once a run (the first reader to ask does; the result
is kept on `ctx`) and writes to standard error the device time a batch of
every span, the share of the busy time launched outside any `serve` span,
and the device's idle gaps, each put down to the innermost span (the
program's or the loop's) open on the host meanwhile. A program without
spans, or a run without a card, yields no time: the readers return None.
"""
from __future__ import annotations

import bisect
import re
import sys
from dataclasses import dataclass, field

import torch

from bench.tracing import _merge, short_name

ROOT_SPAN = "serve"
STAGES = ("serve.lookup", "serve.scan", "serve.rank")
WINDOW = "bench.window"


def is_span(name: str) -> bool:
    """A program span (`serve`, `serve.*`, `nns.*`) or one of the loop's
    (`bench.*`); no operator of PyTorch is named so."""
    return (name == ROOT_SPAN or name.startswith(("serve.", "nns.",
                                                  "bench.")))


@dataclass(frozen=True)
class HostRange:
    """An operator or a span on the host (ns of the trace's clock)."""
    corr: int  # its correlation id, which device operations link to
    name: str
    start: int
    end: int
    thread: int


@dataclass(frozen=True)
class Launch:
    """A call on CUDA's API (runtime or low-level) that queued device
    work."""
    linked: int  # the correlation id of its host range, or 0
    start: int
    thread: int


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start: int
    end: int
    corr: int  # the launch's correlation id
    linked: int  # the correlation id of the host range it was launched in


@dataclass
class SpanTimes:
    batches: int = 0  # `serve` spans in the window
    busy_s: float = 0.0  # device seconds of the window's operations
    outside_s: float = 0.0  # ... of those launched outside any `serve`
    unlinked_s: float = 0.0  # ... of those with no host range nor launch
    inclusive_s: dict = field(default_factory=dict)  # span -> seconds
    exclusive_s: dict = field(default_factory=dict)  # span -> seconds
    ops_by_span: dict = field(default_factory=dict)  # span -> {op: s}
    idle_by_span: dict = field(default_factory=dict)  # innermost -> idle s

    def device_ms(self, name: str):
        """Device ms a batch of the operations launched inside span
        `name`, or None where it recorded no device time."""
        s = self.inclusive_s.get(name, 0.0)
        if self.batches == 0 or s <= 0:
            return None
        return 1e3 * s / self.batches


class _Timeline:
    """The spans of one host thread, properly nested: the innermost open
    at any time, and each span's parent."""

    def __init__(self, spans: list):
        self.spans = spans
        marks = []
        for i, s in enumerate(spans):
            marks.append((s.start, 1, s.start - s.end, i))  # outer first
            marks.append((s.end, 0, s.end - s.start, i))  # inner first
        marks.sort()
        self.at, self.owner, self.parent, stack = [], [], {}, []
        for t, opens, _, i in marks:
            if opens:
                self.parent[i] = stack[-1] if stack else None
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            self.at.append(t)
            self.owner.append(stack[-1] if stack else None)

    def innermost(self, t: int):
        k = bisect.bisect_right(self.at, t) - 1
        return self.owner[k] if k >= 0 else None

    def segments(self, t0: int, t1: int):
        """(innermost span or None, ns) over [t0, t1)."""
        k, at = bisect.bisect_right(self.at, t0) - 1, t0
        while at < t1:
            end = min(self.at[k + 1] if k + 1 < len(self.at) else t1, t1)
            if end > at:
                yield (self.owner[k] if k >= 0 else None), end - at
                at = end
            k += 1


def attribute(hosts: list, launches: dict, ops: list) -> SpanTimes:
    """Device time by span from a trace's host ranges (operators and
    spans), its launches (by correlation id, which a device operation
    shares with its launch) and its device operations."""
    by_corr = {h.corr: h for h in hosts}
    spans_of: dict = {}
    for h in hosts:
        if is_span(h.name):
            spans_of.setdefault(h.thread, []).append(h)
    windows = [h for h in hosts if h.name == WINDOW]
    out = SpanTimes()
    if not windows:
        return out
    w = windows[0]
    lines = {th: _Timeline(sp) for th, sp in spans_of.items()}
    main = lines[w.thread]
    out.batches = sum(1 for s in main.spans if s.name == ROOT_SPAN
                      and w.start <= s.start < w.end)
    chains: dict = {}

    def chain(line, i):
        key = (id(line), i)
        if key not in chains:
            names, j = [], i
            while j is not None:
                names.append(line.spans[j].name)
                j = line.parent[j]
            chains[key] = names
        return chains[key]

    busy = []
    for op in ops:
        a, b = max(op.start, w.start), min(op.end, w.end)
        if b <= a:
            continue
        busy.append((a, b))
        s = (b - a) / 1e9
        out.busy_s += s
        # 0 links to nothing: a host range numbered 0 is not the launch's
        at = by_corr.get(op.linked) if op.linked else None
        if at is None and op.corr in launches:
            launch = launches[op.corr]
            at = (by_corr.get(launch.linked) if launch.linked else None
                  ) or launch
        if at is None:
            out.unlinked_s += s
        line = lines.get(at.thread) if at is not None else None
        i = line.innermost(at.start) if line is not None else None
        names = chain(line, i) if i is not None else []
        if ROOT_SPAN not in names:
            out.outside_s += s
        for name in set(names):
            out.inclusive_s[name] = out.inclusive_s.get(name, 0.0) + s
        if names:
            inner = names[0]
            out.exclusive_s[inner] = out.exclusive_s.get(inner, 0.0) + s
            per_op = out.ops_by_span.setdefault(inner, {})
            key = short_name(op.name)
            per_op[key] = per_op.get(key, 0.0) + s
    at = w.start
    for a, b in _merge(busy) + [[w.end, w.end]]:
        if a > at:
            for i, ns in main.segments(at, a):
                name = main.spans[i].name if i is not None else "none"
                name = "bench.loop" if name == WINDOW else name
                out.idle_by_span[name] = (out.idle_by_span.get(name, 0.0)
                                          + ns / 1e9)
        at = max(at, b)
    return out


# calls on CUDA's API (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync,
# ...): launches, numbered apart from the host ranges, so one number may
# name one of each
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")


def read_profile(prof) -> SpanTimes:
    """`attribute` over a finished `torch.profiler.profile`'s events: on
    the host, the runtime's calls and the other ranges (operators and
    spans); on the device, what ran there, not the ranges that spans leave
    on its timeline."""
    hosts, launches, ops = [], {}, []
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end, linked = start + e.duration_ns(), e.linked_correlation_id()
        if e.device_type() == cpu:
            if RUNTIME_CALL.match(name):
                launches[e.correlation_id()] = Launch(linked, start,
                                                      e.start_thread_id())
            else:
                hosts.append(HostRange(e.correlation_id(), name, start, end,
                                       e.start_thread_id()))
        elif not (is_span(name) or e.is_user_annotation()):
            ops.append(DeviceOp(name, start, end, e.correlation_id(),
                                linked))
    return attribute(hosts, launches, ops)


def profiled_run(loop, batches: int) -> SpanTimes:
    """`batches` batches of the loop, with its spans, under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(loop.device)
    with profile(activities=activities) as prof:
        loop.run(batches=batches, spans=True)
    return read_profile(prof)


def report(t: SpanTimes) -> None:
    """What `span_times` writes to standard error."""
    out = sys.stderr
    if t.busy_s <= 0:
        print("program spans: no device time in the profiled run",
              file=out)
        return
    print(f"program spans: {t.batches} batches, {t.busy_s:.6f} s busy; "
          f"launched outside any {ROOT_SPAN} span {t.outside_s:.6f} s "
          f"({100 * t.outside_s / t.busy_s:.3f}% of busy; with neither "
          f"host range nor launch {t.unlinked_s:.6f} s)", file=out)
    if not t.batches:
        return
    root = t.inclusive_s.get(ROOT_SPAN, 0.0)
    stages = sum(t.inclusive_s.get(s, 0.0) for s in STAGES)
    if root > 0:
        print(f"program spans: stages {', '.join(STAGES)} hold "
              f"{100 * stages / root:.3f}% of {ROOT_SPAN}'s device time",
              file=out)
    for name in sorted(t.inclusive_s):
        ops = sorted(t.ops_by_span.get(name, {}).items(),
                     key=lambda kv: -kv[1])[:4]
        print(f"  {name}: {1e3 * t.inclusive_s[name] / t.batches:.4f} ms "
              f"a batch inclusive, "
              f"{1e3 * t.exclusive_s.get(name, 0.0) / t.batches:.4f} "
              f"exclusive; " + ", ".join(
                  f"{k} {1e3 * v / t.batches:.4f}" for k, v in ops),
              file=out)
    print("program spans: idle s by innermost host span: " + ", ".join(
        f"{k} {v:.6f}" for k, v in sorted(t.idle_by_span.items(),
                                           key=lambda kv: -kv[1])),
          file=out)


def span_times(ctx) -> SpanTimes:
    """The run's device time by span: profiled once, kept on `ctx`."""
    times = getattr(ctx, "program_spans", None)
    if times is None:
        times = profiled_run(ctx.loop, ctx.traffic["trace_batches"])
        ctx.program_spans = times
        report(times)
    return times
