"""The traced window: `torch.profiler` over a fixed number of batches of the
closed loop, after the measured window, and what the readers take from it.

As `chip_smoke.py`'s `device_profile` does, the profiler records CPU and
CUDA activity; the device's events (kernels, copies, fills; not the ranges
that spans leave on the device's timeline) give the busy time, merged
where they overlap, and the kernel time by name. The loop's
own spans (`bench.window` around the traced batches; `bench.stage`,
`bench.serve`, `bench.fetch`, `bench.wait` around its steps) say what the
host was doing in each idle gap of the device.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

HOST_SPANS = ("bench.stage", "bench.serve", "bench.fetch", "bench.wait")


@dataclass
class Trace:
    window_s: float = 0.0  # the traced window, host clock of the trace
    busy_s: float = 0.0  # seconds in which a device operation ran
    kernels: list = field(default_factory=list)  # (name, seconds) each
    idle_by_host: dict = field(default_factory=dict)  # span -> idle seconds
    batches: list = field(default_factory=list)  # TracedBatch

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device seconds of the kernels whose name matches the
        regular expression `pattern`."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernels if rx.search(name))

    def top_ops(self, n: int = 10) -> list:
        by_name: dict = {}
        for name, s in self.kernels:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + s
        return [[k, v] for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.idle_by_host.items(),
                                          key=lambda kv: -kv[1])[:n]]


@dataclass
class TracedBatch:
    slot: int  # the pool batch
    result: dict  # the system's `traced(result)`


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments or template
    arguments, at most 96 characters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip() or name
    return short[:96]


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_profile(prof) -> Trace:
    """Busy time, kernel time by name and idle time by host span, within
    the `bench.window` span of a finished profile (times in us there)."""
    cpu, dev = [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's range on the device's timeline is no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                dev.append((e.name, *r))
        elif e.name == "bench.window" or e.name in HOST_SPANS:
            cpu.append((e.name, *r))
    windows = [(a, b) for name, a, b in cpu if name == "bench.window"]
    if not windows:
        return Trace()
    w0, w1 = windows[0]
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev if b > w0 and a < w1]
    busy = _merge([(a, b) for _, a, b in dev])
    trace = Trace(window_s=(w1 - w0) / 1e6,
                  busy_s=sum(b - a for a, b in busy) / 1e6,
                  kernels=[(n, (b - a) / 1e6) for n, a, b in dev])
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < w1:
        gaps.append((at, w1))
    spans = [(n, a, b) for n, a, b in cpu if n in HOST_SPANS]
    for g0, g1 in gaps:
        covered = 0.0
        for name, a, b in spans:
            overlap = min(b, g1) - max(a, g0)
            if overlap > 0:
                trace.idle_by_host[name] = (trace.idle_by_host.get(name, 0.0)
                                            + overlap / 1e6)
                covered += overlap
        rest = (g1 - g0) - covered
        if rest > 0:
            trace.idle_by_host["bench.loop"] = (
                trace.idle_by_host.get("bench.loop", 0.0) + rest / 1e6)
    return trace


def traced_run(loop, system, batches: int) -> Trace:
    """`batches` batches of the loop under the profiler -> their Trace, with
    each batch's `system.traced(result)` kept for the roofline readers."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(loop.device)
    kept = []

    def keep(landed, in_window):
        kept.append(TracedBatch(landed.slot, system.traced(landed.result)))

    with profile(activities=activities) as prof:
        loop.run(batches=batches, on_land=keep, spans=True)
    trace = read_profile(prof)
    trace.batches = kept
    return trace
